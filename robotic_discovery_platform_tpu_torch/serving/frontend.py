"""Fleet front-end: the gRPC service clients actually dial.

Accepts the existing ``AnalyzeActuatorPerformance`` bidirectional stream
UNCHANGED (same method path, same message bytes -- a client cannot tell a
front-end from a single server) and fans each stream out to one of the
per-host replica servers the :class:`~robotic_discovery_platform_tpu_torch.
serving.fleet.FleetRouter` considers placeable, relaying requests and
responses 1:1 in order.

Failover contract (the part a plain proxy gets wrong): every frame the
front-end has ACCEPTED from the client is either answered by a replica or
error-completed -- never silently dropped.

- Requests are pumped off the client stream into a bounded inbox; a frame
  is appended to the stream's ``pending`` deque BEFORE it is sent to the
  replica, and popped only when its (in-order) response arrives.
- When the replica stream dies at the transport level (replica killed,
  drained, connection refused), the failure counts toward that replica's
  breaker (quarantining it out of the ring without waiting for the next
  health poll) and the pending frames fail over: if the caller's deadline
  still has budget, another placeable replica exists, and the per-stream
  failover budget (``fleet_max_failovers``) is not exhausted, the whole
  pending window is RE-SENT to the new replica and the stream continues
  there; otherwise each pending frame is error-completed with an
  ``ERROR: ReplicaUnavailable`` status response (the same
  keep-the-stream-alive per-frame error contract the replica server
  itself uses).
- With one replica and no failure, the relay is a transparent pass-through:
  the 1-replica fleet path is bitwise-identical to dialing the replica
  directly (held in tests/test_torch_port_fleet.py).

The front-end's own grpc.health.v1 readiness tracks fleet membership:
SERVING while at least one replica is placeable, NOT_SERVING otherwise --
so front-ends themselves compose (a load balancer can health-gate them the
same way they health-gate replicas).

Observability plane (the fleet's one-stop view):

- every relayed frame records a **relay timeline** in the front-end's
  flight recorder (accept -> send [-> failover -> re-send] -> answer),
  parented under the client's trace context -- and the client's original
  ``traceparent`` is forwarded on EVERY failover attempt (minted by the
  front-end when the client sent none), so one trace ID follows a frame
  across replicas;
- ``GET /debug/trace?id=<trace_id>`` on the front-end's metrics port
  stitches those relay timelines with every replica's matching dispatch
  timelines (scraped from their ``/debug/spans``, last-good-cached so a
  dead replica's evidence survives it) into ONE distributed tree;
- ``GET /federate`` re-exposes every replica's metric families under a
  ``replica`` label with ``rdp_replica_up``/staleness markers and fleet
  roll-ups (observability/federation.py);
- membership changes, drains, and failover decisions land in the
  structured event journal (``GET /debug/events?since=``), and on an
  elastic front-end ``/debug/events`` serves the FLEET-wide merge: the
  front-end's own journal plus every member's (live-scraped, last-good
  cached), ordered by wall clock -- the same discipline as the stitched
  ``/debug/trace``.

**Elastic membership** (``ServerConfig.fleet_elastic`` /
``RDP_FLEET_ELASTIC``): the front-end runs a
:class:`~robotic_discovery_platform_tpu_torch.serving.fleet.LeaseRegistry`
and serves Register/Renew/Leave next to its vision service, so replicas
announce themselves (serving/fleet.py ``LeaseClient``) instead of being
listed in config -- a replica respawned on a NEW port rejoins with zero
config edits. Replicated front-ends stay coordinator-free: each serves
its lease table + placement loads over the stats RPC and gossips with
its siblings (``fleet_peers`` / ``RDP_FLEET_PEERS``), adopting leases it
has not heard directly and folding sibling load into placement. With
``autoscaler_enabled`` the front-end also runs the capacity planner's
control loop (serving/planner.py): scale-up spawns a self-registering
replica, scale-down drains the least-loaded leased member through the
Drain RPC. All of it is off by default -- the static fleet path is
bitwise-unchanged.

The port's copy of the JAX package's module, imports rewritten; the
relay, the failover contract, ``/federate`` and ``/debug/trace`` are the
JAX front-end's. Like fleet.py, this module imports no torch and nothing
of the port's ``ops/`` or ``models/``: the front-end routes bytes and
never touches the card. The autoscaler's replica spawner
(``serving/replica.py``) is imported when it first spawns, and the
replicas it spawns run on ``replica_device`` (``"cuda"`` unless the
caller asks for the CPU, as the tests do).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent import futures
from dataclasses import dataclass, field
from pathlib import Path

import grpc

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    exposition,
    federation as federation_lib,
    journal as journal_lib,
    recorder as recorder_lib,
    trace,
)
from robotic_discovery_platform_tpu_torch.serving import (
    fleet as fleet_lib,
    health as health_lib,
    planner as planner_lib,
)
from robotic_discovery_platform_tpu_torch.serving.proto import (
    vision_grpc,
    vision_pb2,
)
from robotic_discovery_platform_tpu_torch.utils.config import ServerConfig
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: client metadata keys forwarded to the replica (gRPC reserves the rest;
#: traceparent is what makes a frame's client-side failure join the
#: replica's /debug/spans timeline)
_FORWARDED_METADATA = (trace.TRACEPARENT,)

#: how often a feeder blocked on an idle client re-checks its generation
#: (a retired feeder must notice the failover and stand down)
_FEED_POLL_S = 0.05

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")


def _matching_timelines(snapshot: dict, trace_id: str) -> list[dict]:
    """Timelines (recent + pinned, deduped by seq) holding at least one
    span of ``trace_id``, from a /debug/spans-shaped payload."""
    out: list[dict] = []
    seen: set[int] = set()
    for section in ("recent", "pinned"):
        for tl in snapshot.get(section, []) or []:
            if tl.get("seq") in seen:
                continue
            if any(s.get("trace_id") == trace_id
                   for s in tl.get("spans", [])):
                seen.add(tl.get("seq"))
                out.append(tl)
    out.sort(key=lambda t: t.get("created_unix_s") or 0.0)
    return out


def _span_forest(spans: list[dict]) -> list[dict]:
    """Nest flat span records by their parent links (roots first, each
    with a ``children`` list); orphaned parents degrade to roots."""
    by_id = {s.get("span_id"): {**s, "children": []} for s in spans}
    roots: list[dict] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def _stitch_tree(trace_id: str, sources: list[dict]) -> dict:
    """One distributed tree: a synthetic trace root whose children are
    the per-process sources (role/host/endpoint), each holding its
    matching timelines with spans nested by parent link. Cross-host
    ordering uses wall-clock ``created_unix_s`` (monotonic_ns stamps are
    not comparable across processes)."""
    children = []
    for src in sources:
        if not src["timelines"]:
            continue
        children.append({
            "role": src["role"],
            "host": src["host"],
            "endpoint": src["endpoint"],
            "stale": not src["fresh"],
            "timelines": [
                {
                    "name": tl.get("name"),
                    "seq": tl.get("seq"),
                    "labels": tl.get("labels", {}),
                    "error": tl.get("error"),
                    "created_unix_s": tl.get("created_unix_s"),
                    "duration_ms": tl.get("duration_ms"),
                    "spans": _span_forest(tl.get("spans", [])),
                }
                for tl in src["timelines"]
            ],
        })
    return {"trace_id": trace_id, "children": children}


class _RelayFrame:
    """One accepted frame riding the relay, plus its flight-recorder
    timeline (accept -> send [-> failover -> re-send] -> answer).

    Span ownership follows the frame's ownership hand-off: the feeder
    opens spans before the frame becomes visible to the response loop
    (appended to ``pending`` under the stream lock), the response loop
    or the failover handler closes them -- never both at once, so span
    mutation needs no lock of its own."""

    __slots__ = ("req", "accept_ns", "timeline", "root", "send_span",
                 "attempts")

    def __init__(self, req):
        self.req = req
        self.accept_ns = time.monotonic_ns()
        self.timeline: recorder_lib.Timeline | None = None
        self.root = None
        self.send_span = None
        self.attempts = 0

    def ensure_started(self, trace_id: str | None) -> None:
        """Open the timeline on first send (idempotent: a stashed frame
        re-fed by a later attempt keeps its original accept span)."""
        if self.timeline is not None:
            return
        tl = recorder_lib.Timeline("relay")
        now = time.monotonic_ns()
        self.root = tl.span("relay", start_ns=self.accept_ns,
                            trace_id=trace_id)
        tl.span("accept", start_ns=self.accept_ns, end_ns=now,
                parent=self.root, trace_id=trace_id)
        self.timeline = tl

    def begin_send(self, endpoint: str, trace_id: str | None) -> None:
        self.ensure_started(trace_id)
        self.attempts += 1
        self.send_span = self.timeline.span(
            "send", start_ns=time.monotonic_ns(), parent=self.root,
            trace_id=trace_id, replica=endpoint, attempt=self.attempts,
        )

    def mark_failover(self, frm: str, to: str, trace_id: str | None,
                      why: str) -> None:
        """Close the dead attempt's send span and stamp the hop itself
        as a point span -- the 'failover hop' the stitched /debug/trace
        shows."""
        now = time.monotonic_ns()
        if self.send_span is not None and self.send_span.end_ns is None:
            self.send_span.end(now)
            self.send_span.attributes["error"] = why
        self.ensure_started(trace_id)
        self.timeline.span("failover", start_ns=now, end_ns=now,
                           parent=self.root, trace_id=trace_id,
                           frm=frm, to=to, reason=why)

    def finish(self, recorder: recorder_lib.FlightRecorder,
               error: str | None = None) -> None:
        """Answer delivered (or error-completed): close the open spans
        and hand the timeline to the recorder (errored timelines pin)."""
        if self.timeline is None:
            return
        now = time.monotonic_ns()
        if self.send_span is not None and self.send_span.end_ns is None:
            self.send_span.end(now)
        if self.root is not None and self.root.end_ns is None:
            self.root.end(now)
        self.timeline.labels["attempts"] = str(self.attempts)
        if error is not None:
            self.timeline.fail(error)
        recorder.record(self.timeline)
        self.timeline = None  # record exactly once


class _StreamState:
    """Shared state of one relayed client stream across failover attempts."""

    __slots__ = ("lock", "inbox", "pending", "stash", "client_done",
                 "closed", "gen", "pump_error", "trace_id")

    def __init__(self, inbox_depth: int = 64,
                 trace_id: str | None = None):
        self.lock = checked_lock("frontend.stream")
        # bounded: a slow replica backpressures the pump thread, and gRPC
        # flow control pushes that back to the client
        self.inbox: queue.Queue = queue.Queue(maxsize=inbox_depth)
        #: sent to the current replica, response not yet relayed
        self.pending: deque[_RelayFrame] = deque()  # guarded_by: lock
        #: pulled from the inbox by a retired feeder after its attempt
        #: died; the next attempt's feeder drains this first
        self.stash: deque[_RelayFrame] = deque()  # guarded_by: lock
        self.client_done = False
        self.closed = False
        #: failover generation; a feeder retires when it no longer matches
        self.gen = 0
        self.pump_error: BaseException | None = None
        #: the stream's trace ID (client's traceparent, or front-end
        #: minted) stamped onto every relay span
        self.trace_id = trace_id


def _pump(request_iterator, st: _StreamState) -> None:
    """Client-side pump: the ONE consumer of the client request iterator,
    so failover attempts never race over it. Each request is wrapped in
    a :class:`_RelayFrame` here -- acceptance is where the frame's relay
    timeline starts."""
    try:
        for req in request_iterator:
            frame = _RelayFrame(req)
            while True:
                try:
                    st.inbox.put(frame, timeout=0.1)
                    break
                except queue.Full:
                    if st.closed:
                        return
    except Exception as exc:  # noqa: BLE001 - client reset mid-stream
        st.pump_error = exc
    finally:
        st.client_done = True


class FleetFrontend(vision_grpc.VisionAnalysisServiceServicer):
    """The relay servicer. One instance per front-end process; per-stream
    state lives on the stack of each handler."""

    def __init__(self, router: fleet_lib.FleetRouter,
                 cfg: ServerConfig = ServerConfig(),
                 flight_recorder: recorder_lib.FlightRecorder | None = None,
                 registry: fleet_lib.LeaseRegistry | None = None):
        self.router = router
        self.cfg = cfg
        #: the elastic-membership lease table (None = static fleet);
        #: build_frontend registers its Register/Renew/Leave RPCs next
        #: to the vision service on this front-end's own port
        self.registry = registry
        #: sibling-gossip loop + autoscaler supervisor (build_frontend
        #: wires them when configured; close() stops them)
        self.gossip: fleet_lib.PeerGossip | None = None
        self.supervisor: planner_lib.ElasticSupervisor | None = None
        self.bound_port = 0  # set by build_frontend after the port bind
        #: replica subprocesses the autoscaler spawned, by endpoint --
        #: scale-down retires them; close() terminates any survivors
        self.spawned: dict[str, object] = {}  # guarded_by: _spawn_lock
        self._spawn_lock = checked_lock("frontend.spawned")
        self.health = health_lib.HealthServicer()
        self.health.set(vision_grpc.SERVICE_NAME, health_lib.NOT_SERVING)
        router.on_membership = self._on_membership
        self.metrics_server: exposition.MetricsServer | None = None
        #: where relay timelines land (GET /debug/spans on the front-end)
        self.recorder = (flight_recorder if flight_recorder is not None
                         else recorder_lib.RECORDER)
        #: the fleet scrape cache + /federate renderer; its background
        #: poll starts with the metrics server (build_frontend) so the
        #: last-good evidence of a replica that dies between queries is
        #: already cached when /debug/trace asks for it
        self.federator = federation_lib.FleetFederator(
            self._scrape_targets,
            timeout_s=cfg.fleet_probe_timeout_s,
            poll_s=max(cfg.fleet_poll_s, 0.25),
        )
        # optional drift-triggered rollout supervisor (serving/rollout.py;
        # duck-typed so this module stays torch-free): set via
        # set_rollout_manager, stopped with the front-end, surfaced at
        # GET /debug/rollout on the front-end's metrics endpoint
        self.rollout = None
        self._closed = False

    def set_rollout_manager(self, manager) -> None:
        """Attach the rollout manager whose lifecycle this front-end
        owns: /debug/rollout serves its snapshot, close() stops it."""
        self.rollout = manager
        if self.metrics_server is not None:
            self.metrics_server.set_rollout_provider(
                lambda: (self.rollout.snapshot()
                         if self.rollout is not None
                         else {"enabled": False,
                               "reason": "no rollout manager attached"}))

    # -- membership-driven readiness ----------------------------------------

    def _on_membership(self, live: int) -> None:
        status = (health_lib.SERVING if live > 0 and not self._closed
                  else health_lib.NOT_SERVING)
        self.health.set("", status)
        self.health.set(vision_grpc.SERVICE_NAME, status)

    # -- observability plane --------------------------------------------------

    def _scrape_targets(self) -> list[federation_lib.ScrapeTarget]:
        """The federator's view of the fleet: every configured replica
        (live or not -- a dead member must still be marked, not
        omitted), its advertised metrics URL, and its last stats
        payload."""
        return [
            federation_lib.ScrapeTarget(
                replica=r.endpoint,
                base_url=r.metrics_base_url,
                stats=r.stats,
            )
            for r in self.router.replicas
        ]

    def trace_debug(self, trace_id: str) -> dict:
        """The ``GET /debug/trace?id=`` stitcher: the front-end's relay
        timelines for this trace merged with every replica's matching
        dispatch/ingest timelines (live-scraped, falling back to the
        federator's last-good cache for dead members) into one
        distributed tree keyed by the trace ID."""
        tid = (trace_id or "").strip().lower()
        if not _TRACE_ID_RE.match(tid):
            return {"error": f"bad trace id {trace_id!r} "
                             "(want 32 lowercase hex chars)"}
        host, role = trace.identity()
        sources = [{
            "role": "frontend",
            "host": host,
            "endpoint": None,
            "fresh": True,
            "scrape_age_s": 0.0,
            "timelines": _matching_timelines(self.recorder.snapshot(),
                                             tid),
        }]
        for target, payload, age_s, fresh in self.federator.span_payloads():
            source = {
                "role": (payload or {}).get("role", "replica"),
                "host": (payload or {}).get("host", ""),
                "endpoint": target.replica,
                "fresh": fresh,
                "scrape_age_s": age_s,
                "timelines": (_matching_timelines(payload, tid)
                              if payload is not None else []),
            }
            if payload is None:
                source["error"] = "unreachable and never scraped"
            sources.append(source)
        return {
            "trace_id": tid,
            "timelines_total": sum(len(s["timelines"]) for s in sources),
            "sources": sources,
            "tree": _stitch_tree(tid, sources),
        }

    def frontend_stats(self) -> dict:
        """This front-end's stats-RPC payload -- the gossip surface its
        siblings poll: identity, the lease table, and the per-replica
        placement loads they fold into their own rings."""
        host, role = trace.identity()
        loads = self.router.placement_loads()
        return {
            "role": role or "frontend",
            "host": host,
            "pid": os.getpid(),
            "draining": self._closed,
            "inflight_streams": sum(loads.values()),
            "live_replicas": self.router.live_count,
            "leases": (self.registry.snapshot()
                       if self.registry is not None else {}),
            "replica_loads": loads,
            "metrics_port": (self.metrics_server.port
                             if self.metrics_server is not None else 0),
        }

    def events_debug(self, since: int = 0) -> dict:
        """The fleet-wide ``GET /debug/events`` aggregation: the
        front-end's own journal merged with every member's (live-scraped
        ``/debug/events``, falling back to the federator's last-good
        cache for dead members -- a SIGKILLed replica's final entries
        survive it), ordered by wall clock then per-process seq, the
        same cross-host ordering the /debug/trace stitcher uses. Every
        event carries its source host/role (stamped at append time) plus
        a ``source`` endpoint marker added here. The ``since`` cursor
        applies to the front-end's OWN journal (member rings are bounded
        and merged whole; their cursors live in their own processes)."""
        own = journal_lib.JOURNAL.snapshot(since)
        merged = [dict(e, source="frontend") for e in own["events"]]
        sources: list[dict] = [{
            "source": "frontend",
            "endpoint": None,
            "host": own["host"],
            "role": own["role"],
            "fresh": True,
            "scrape_age_s": 0.0,
            "events": len(own["events"]),
            "dropped_total": own["dropped_total"],
        }]
        for target, payload, age_s, fresh in (
                self.federator.journal_payloads()):
            src = {
                "source": target.replica,
                "endpoint": target.replica,
                "fresh": fresh,
                "scrape_age_s": age_s,
            }
            if payload is None:
                src["events"] = 0
                src["error"] = "unreachable and never scraped"
            else:
                src["host"] = payload.get("host", "")
                src["role"] = payload.get("role", "replica")
                member_events = payload.get("events", []) or []
                src["events"] = len(member_events)
                src["dropped_total"] = payload.get("dropped_total", 0)
                merged.extend(dict(e, source=target.replica)
                              for e in member_events)
            sources.append(src)
        merged.sort(key=lambda e: ((e.get("unix_ts") or 0.0),
                                   (e.get("seq") or 0)))
        return {
            "role": "frontend",
            "since": since,
            "next_cursor": own["next_cursor"],
            "sources": sources,
            "events_total": len(merged),
            "events": merged,
        }

    # -- the relay -----------------------------------------------------------

    def _feed(self, st: _StreamState, gen: int, resend: list,
              endpoint: str):
        """Request generator for ONE failover attempt: re-sends the
        pending window first (already in ``st.pending``), then relays new
        frames -- each appended to ``pending`` before it is yielded, so a
        frame gRPC pulled but never delivered is still accounted for.
        Every yield opens a ``send`` span on the frame's relay timeline
        (attempt-numbered, replica-labeled)."""
        for frame in resend:
            if st.gen != gen:
                return
            frame.begin_send(endpoint, st.trace_id)
            yield frame.req
        while True:
            if st.gen != gen or st.closed:
                return
            frame = None
            with st.lock:
                if st.stash:
                    frame = st.stash.popleft()
            if frame is None:
                try:
                    frame = st.inbox.get(timeout=_FEED_POLL_S)
                except queue.Empty:
                    if st.client_done and st.inbox.empty():
                        with st.lock:
                            if not st.stash:
                                return
                    continue
            if st.gen != gen or st.closed:
                # pulled after this attempt retired: hand the frame to the
                # next attempt instead of dropping it
                with st.lock:
                    st.stash.append(frame)
                return
            frame.begin_send(endpoint, st.trace_id)
            with st.lock:
                st.pending.append(frame)
            yield frame.req

    @staticmethod
    def _forwarded_metadata(context) -> tuple:
        return tuple(
            (k, v) for k, v in context.invocation_metadata()
            if k in _FORWARDED_METADATA
        )

    @staticmethod
    def _time_remaining(context) -> float | None:
        """The caller's remaining deadline budget in seconds, or None for
        "no deadline". grpc reports deadline-less streams as ~INT64_MAX
        nanoseconds, which overflows a client-side timeout into an
        immediately-expired deadline -- normalize anything implausibly
        large to None."""
        remaining = context.time_remaining()
        if remaining is None or remaining > 86400.0 * 365:
            return None
        return remaining

    def AnalyzeActuatorPerformance(self, request_iterator, context):
        router = self.router
        # the stream's trace: the client's traceparent when sent, a
        # front-end-minted context otherwise -- forwarded to the replica
        # on EVERY attempt, so a failed-over frame keeps one trace ID
        # end to end and the replicas' dispatch timelines join the
        # front-end's relay timelines under it
        remote = trace.from_metadata(context.invocation_metadata())
        stream_ctx = trace.new_context(remote)
        st = _StreamState(trace_id=stream_ctx.trace_id)
        replica = router.pick()
        if replica is None:
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "no live replica in the serving fleet; retry later",
            )
        pump = threading.Thread(
            target=_pump, args=(request_iterator, st),
            name="fleet-pump", daemon=True,
        )
        pump.start()
        metadata = self._forwarded_metadata(context)
        if not any(k.lower() == trace.TRACEPARENT for k, _ in metadata):
            metadata = metadata + trace.to_metadata(stream_ctx)
        failovers = 0
        try:
            while True:
                st.gen += 1
                with st.lock:
                    resend = list(st.pending)
                try:
                    call = replica.stub.AnalyzeActuatorPerformance(
                        self._feed(st, st.gen, resend, replica.endpoint),
                        timeout=self._time_remaining(context),
                        metadata=metadata,
                    )
                    for resp in call:
                        frame = None
                        with st.lock:
                            if st.pending:
                                frame = st.pending.popleft()
                        if frame is not None:
                            # answer delivered: the relay timeline closes
                            # and enters the front-end's /debug/spans ring
                            frame.finish(self.recorder)
                        # under the router lock: concurrent streams share
                        # this replica, and a bare += here drops counts
                        router.count_frame(replica)
                        yield resp
                    # replica closed the stream cleanly (our feeder ended
                    # after the client finished). A deadline-expired
                    # replica loop can end with unanswered frames --
                    # error-complete them rather than dropping silently.
                    router.on_stream_ok(replica)
                    yield from self._error_complete(
                        st, replica, "stream ended with frames unanswered")
                    return
                except grpc.RpcError as exc:
                    if not context.is_active():
                        return  # client is gone; nothing left to complete
                    code = (exc.code() if hasattr(exc, "code") else None)
                    router.on_stream_error(replica, exc)
                    failovers += 1
                    with st.lock:
                        n_pending = len(st.pending)
                    remaining = self._time_remaining(context)
                    has_budget = (failovers <= self.cfg.fleet_max_failovers
                                  and (remaining is None or remaining > 0))
                    next_replica = (router.pick(exclude=replica)
                                    if has_budget else None)
                    if next_replica is not None:
                        log.warning(
                            "fleet failover: replica %s died (%s); "
                            "re-routing %d in-flight frame(s) to %s "
                            "(failover %d/%d)",
                            replica.endpoint, code, n_pending,
                            next_replica.endpoint, failovers,
                            self.cfg.fleet_max_failovers,
                        )
                        # each stranded frame's timeline records the hop
                        # (its re-send opens a fresh attempt-numbered
                        # send span on the new replica)
                        with st.lock:
                            stranded = list(st.pending)
                        for frame in stranded:
                            frame.mark_failover(
                                replica.endpoint, next_replica.endpoint,
                                st.trace_id, f"replica died ({code})")
                        self._record_hop(
                            st, replica.endpoint, next_replica.endpoint,
                            n_pending, f"replica died ({code})")
                        journal_lib.JOURNAL.append(
                            events.FLEET_FAILOVER, trace_id=st.trace_id,
                            frm=replica.endpoint,
                            to=next_replica.endpoint,
                            outcome="rerouted", frames=n_pending,
                            code=str(code),
                        )
                        router.record_failover(rerouted=n_pending)
                        router.release(replica)
                        replica = next_replica
                        continue
                    # no replica (or no budget) to re-route to: every
                    # accepted in-flight frame error-completes, then the
                    # stream itself fails over to the client
                    log.warning(
                        "fleet: replica %s died (%s) with no failover "
                        "target; error-completing %d in-flight frame(s)",
                        replica.endpoint, code, n_pending,
                    )
                    self._record_hop(
                        st, replica.endpoint, "", n_pending,
                        f"replica died ({code}); no failover target")
                    journal_lib.JOURNAL.append(
                        events.FLEET_FAILOVER, trace_id=st.trace_id,
                        frm=replica.endpoint, to="",
                        outcome="error_completed", frames=n_pending,
                        code=str(code),
                    )
                    router.record_failover(error_completed=n_pending)
                    yield from self._error_complete(
                        st, replica, f"replica unavailable ({code})")
                    if (st.client_done and st.inbox.empty()
                            and not st.stash):
                        return  # every accepted frame was answered
                    context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        f"fleet: replica {replica.endpoint} unavailable "
                        f"({code}) and no healthy replica to fail over "
                        "to; in-flight frames were error-completed",
                    )
        finally:
            st.closed = True
            st.gen += 1  # retire any feeder blocked on an idle client
            if replica is not None:
                router.release(replica)

    def _record_hop(self, st: _StreamState, frm: str, to: str,
                    frames: int, why: str) -> None:
        """Pin a stream-level failover timeline: even when the transport
        died BETWEEN frames (nothing stranded, nothing re-sent), the
        stitched /debug/trace must show the hop."""
        tl = recorder_lib.Timeline(
            events.FLEET_FAILOVER, labels={"frm": frm, "to": to or "-"})
        now = time.monotonic_ns()
        tl.span("failover", start_ns=now, end_ns=now,
                trace_id=st.trace_id, frm=frm, to=to, frames=frames,
                reason=why)
        self.recorder.pin(self.recorder.record(tl))

    def _error_complete(self, st: _StreamState, replica, why: str):
        """Yield one ERROR-status response per pending frame (in order),
        clearing the pending window -- the fleet-level analogue of the
        replica server's keep-the-stream-alive per-frame errors. Each
        frame's relay timeline records errored (and therefore pins)."""
        with st.lock:
            stranded = list(st.pending)
            st.pending.clear()
        for frame in stranded:
            frame.finish(self.recorder,
                         error=f"ReplicaUnavailable: {replica.endpoint}: "
                               f"{why}")
            yield vision_pb2.AnalysisResponse(
                status=f"ERROR: ReplicaUnavailable: {replica.endpoint}: "
                       f"{why}; frame error-completed by fleet front-end "
                       f"[trace={st.trace_id or '-'}]",
            )

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        self.health.set_all(health_lib.NOT_SERVING)
        # the autoscaler first (no more spawns), then its children: any
        # member it spawned that scale-down never retired dies with the
        # front-end that owns it
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        if self.gossip is not None:
            self.gossip.stop()
            self.gossip = None
        with self._spawn_lock:
            orphans = list(self.spawned.values())
            self.spawned.clear()
        for handle in orphans:
            try:
                handle.terminate()
            except Exception:  # pragma: no cover - teardown best-effort
                log.exception("spawned replica teardown failed")
        if self.rollout is not None:
            try:
                self.rollout.stop()
            except Exception:  # pragma: no cover - teardown best-effort
                log.exception("rollout manager stop failed")
            self.rollout = None
        self.federator.stop()
        self.router.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None


def build_frontend(
    cfg: ServerConfig = ServerConfig(), *, replica_device: str = "cuda",
) -> tuple[grpc.Server, FleetFrontend]:
    """Wire an unstarted (server, frontend) over ``cfg.fleet_replicas`` /
    ``RDP_FLEET_REPLICAS``. Mirrors serving/server.build_server: binds
    ``cfg.address``, registers the vision service + grpc.health.v1, starts
    the membership poller and the optional /metrics endpoint. Raises when
    the replica list is empty (a front-end with nothing behind it is a
    misconfiguration, not a degraded mode). ``replica_device`` is where
    the autoscaler's spawned replicas serve."""
    endpoints = fleet_lib.resolve_fleet_replicas(cfg.fleet_replicas)
    elastic = fleet_lib.resolve_fleet_elastic(cfg.fleet_elastic)
    if not endpoints and not elastic:
        raise ValueError(
            "fleet front-end needs replica endpoints "
            "(ServerConfig.fleet_replicas / RDP_FLEET_REPLICAS) or "
            "elastic membership (fleet_elastic / RDP_FLEET_ELASTIC)"
        )
    registry = (fleet_lib.LeaseRegistry(ttl_s=cfg.fleet_lease_ttl_s)
                if elastic else None)
    controller = None
    if cfg.fleet_controller_enabled:
        controller = fleet_lib.FleetController(
            burn_high=cfg.fleet_burn_high,
            weight_floor=cfg.fleet_weight_floor,
        )
    router = fleet_lib.FleetRouter(
        endpoints,
        poll_s=cfg.fleet_poll_s,
        probe_timeout_s=cfg.fleet_probe_timeout_s,
        breaker_failures=cfg.fleet_breaker_failures,
        breaker_reset_s=cfg.fleet_breaker_reset_s,
        controller=controller,
        registry=registry,
    )
    # this process is the fleet's front-end: spans and journal events it
    # records are attributed to that role in merged multi-process output
    trace.set_identity(role="frontend")
    frontend = FleetFrontend(router, cfg, registry=registry)
    router.start()  # includes one immediate membership tick
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=cfg.max_workers)
    )
    vision_grpc.add_VisionAnalysisServiceServicer_to_server(
        frontend, server)
    health_lib.add_HealthServicer_to_server(frontend.health, server)
    if elastic:
        # the membership surface rides the front-end's own port: the
        # stats RPC (identity + lease table + placement loads -- what
        # sibling front-ends gossip over) and Register/Renew/Leave (what
        # self-announcing replicas call)
        fleet_lib.add_fleet_rpcs_to_server(
            server, stats_provider=frontend.frontend_stats,
            registry=registry)
    frontend.bound_port = server.add_insecure_port(cfg.address)
    frontend.metrics_server = exposition.maybe_start_metrics_server(
        cfg.metrics_port
    )
    if frontend.metrics_server is not None:
        # the fleet-only surfaces ride the front-end's metrics port:
        # /debug/trace (cross-host stitch), /federate (one Prometheus
        # target for the fleet), /debug/events (fleet-wide journal
        # merge), and the federator's warm cache
        frontend.metrics_server.set_trace_provider(frontend.trace_debug)
        frontend.metrics_server.set_federation_provider(
            frontend.federator.render)
        frontend.metrics_server.set_events_provider(frontend.events_debug)
        frontend.federator.start()
    peers = fleet_lib.resolve_fleet_peers(cfg.fleet_peers)
    if peers and registry is not None:
        frontend.gossip = fleet_lib.PeerGossip(
            peers, registry=registry, router=router,
            poll_s=max(cfg.fleet_poll_s, 0.25),
            rpc_timeout_s=cfg.fleet_probe_timeout_s,
        )
        frontend.gossip.start()
    if cfg.autoscaler_enabled and elastic:
        frontend.supervisor = _wire_autoscaler(
            frontend, cfg, frontend.bound_port, replica_device)
        frontend.supervisor.start()
    log.info("fleet front-end over %d static replica(s)%s: %s",
             len(endpoints),
             " + elastic leases" if elastic else "",
             ", ".join(endpoints) or "(lease-only membership)")
    return server, frontend


def _wire_autoscaler(frontend: FleetFrontend, cfg: ServerConfig,
                     port: int, replica_device: str = "cuda",
                     ) -> planner_lib.ElasticSupervisor:
    """Bind the planner's control loop to THIS front-end: demand from
    the live /federate roll-ups, scale-up through the replica spawner
    (self-registering against this front-end's own port), scale-down
    through the Drain RPC on the least-loaded leased member."""
    capacity = planner_lib.CapacityModel.resolve(cfg.planner_capacity_path)
    registrar = f"localhost:{port}"

    def observe() -> dict:
        # the planner eats exactly what a human capacity-planner reads:
        # the federated scrape's fleet roll-ups. Live count comes from
        # the router (placeable now beats a gauge scraped a tick ago).
        rollups = planner_lib.parse_federate_rollups(
            frontend.federator.render())
        rollups["live"] = frontend.router.live_count
        return rollups

    def scale_up() -> str:
        from robotic_discovery_platform_tpu_torch.serving import (
            replica as replica_lib,
        )

        handle = replica_lib.spawn_local_replicas(
            1, cfg.tracking_uri,
            img_size=cfg.model_img_size,
            window_ms=cfg.batch_window_ms or 2.0,
            slo_ms=cfg.slo_ms,
            metrics_port=-1,
            registrars=registrar,
            lease_ttl_s=cfg.fleet_lease_ttl_s,
            device=replica_device,
        )[0]
        with frontend._spawn_lock:
            frontend.spawned[handle.endpoint] = handle
        return handle.endpoint

    def pick_drain() -> str | None:
        # leased members only (never a static seed), least loaded first
        static = frontend.router.static_endpoints
        candidates = [r for r in frontend.router.replicas
                      if r.placeable and r.endpoint not in static]
        if not candidates:
            return None
        return min(candidates, key=lambda r: r.effective_load).endpoint

    def scale_down(endpoint: str) -> None:
        member = next((r for r in frontend.router.replicas
                       if r.endpoint == endpoint), None)
        if member is None:
            return
        # the servicer's graceful path: set_draining on the member -- health
        # stays SERVING, in-flight streams finish, placement stops
        member.stats_stub.Drain(
            json.dumps({"draining": True}).encode("utf-8"),
            timeout=max(cfg.fleet_probe_timeout_s, 1.0))
        member.draining = True  # act now; the next scrape re-confirms
        with frontend._spawn_lock:
            handle = frontend.spawned.pop(endpoint, None)
        if handle is not None:
            # deliberately unowned: the reaper outlives nothing (bounded
            # deadline, then SIGTERM on the handle), and close() kills
            # any spawned member it hadn't retired yet
            threading.Thread(  # jaxlint: disable=JL012
                target=_reap_drained,
                args=(frontend.router, endpoint, handle,
                      cfg.drain_grace_s),
                name="fleet-reaper", daemon=True,
            ).start()

    return planner_lib.ElasticSupervisor(
        observe=observe,
        scale_up=scale_up,
        scale_down=scale_down,
        pick_drain=pick_drain,
        capacity=capacity,
        autoscaler=planner_lib.Autoscaler(
            min_replicas=cfg.autoscaler_min_replicas,
            max_replicas=cfg.autoscaler_max_replicas,
            sustain_s=cfg.autoscaler_sustain_s,
            cooldown_s=cfg.autoscaler_cooldown_s,
        ),
        headroom=cfg.planner_headroom,
        window_ms=cfg.batch_window_ms or 2.0,
        poll_s=max(cfg.fleet_poll_s, 0.25),
        flight_recorder=frontend.recorder,
    )


def _reap_drained(router: fleet_lib.FleetRouter, endpoint: str,
                  handle, grace_s: float) -> None:
    """Retire one autoscaler-spawned member AFTER its drain completes:
    wait (bounded) for its in-flight count to hit zero, then SIGTERM --
    the replica's own shutdown sends the lease Leave."""
    deadline = time.monotonic() + max(5.0, 2.0 * grace_s)
    while time.monotonic() < deadline:
        member = next((r for r in router.replicas
                       if r.endpoint == endpoint), None)
        if member is None or (member.inflight == 0
                              and member.external == 0):
            break
        time.sleep(0.2)
    try:
        handle.terminate()
    except Exception:  # pragma: no cover - teardown best-effort
        log.exception("autoscaler retire of %s failed", endpoint)


def serve_frontend(cfg: ServerConfig = ServerConfig()) -> None:
    server, frontend = build_frontend(cfg)
    server.start()
    log.info("fleet front-end listening on %s", cfg.address)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        log.info("interrupt: shutting down fleet front-end")
    finally:
        server.stop(grace=cfg.drain_grace_s).wait()
        frontend.close()


# -- local front-end cluster (tests / CI / smoke tools) ----------------------


#: how long spawn_local_frontends waits for each child's JSON line
_SPAWN_TIMEOUT_S = 60.0

#: the package root, prepended to each child's PYTHONPATH (same
#: hermeticity reasoning as serving/replica.py)
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


@dataclass
class LocalFrontend:
    """One spawned front-end subprocess and how to reach / kill it."""

    proc: subprocess.Popen
    endpoint: str
    port: int
    metrics_port: int = 0
    argv: list[str] = field(default_factory=list)
    env: dict = field(default_factory=dict)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Abrupt death (SIGKILL): the chaos leg -- a client retrying
        against a sibling must lose zero accepted frames."""
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=30)

    def terminate(self, timeout_s: float = 15.0) -> None:
        if self.alive():
            self.proc.terminate()
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:  # pragma: no cover
            self.proc.kill()
            self.proc.wait(timeout=10)


def _free_port() -> int:
    """Reserve-and-release an ephemeral port. Racy by nature, but the
    front-end mesh needs every sibling's port BEFORE any of them boots
    (each is a peer of the others), so bind-at-boot can't work."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_worker(argv: list[str], env: dict,
                  timeout_s: float) -> tuple[subprocess.Popen, dict]:
    proc = subprocess.Popen(
        argv, env=env, stdout=subprocess.PIPE, stderr=sys.stderr,
        text=True,
    )
    deadline = time.monotonic() + timeout_s
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.strip():
            break
        if proc.poll() is not None:
            raise RuntimeError(
                f"front-end exited rc={proc.returncode} before "
                "reporting its port")
    try:
        payload = json.loads(line)
        int(payload["port"])
    except Exception as exc:
        proc.kill()
        raise RuntimeError(
            f"front-end did not report a port (got {line!r})") from exc
    return proc, payload


def spawn_local_frontends(
    n: int,
    *,
    replicas: str = "",
    tracking_uri: str = "",
    elastic: bool = True,
    lease_ttl_s: float = 2.0,
    poll_s: float = 0.25,
    window_ms: float = 2.0,
    autoscaler: bool = False,
    autoscaler_min: int = 1,
    autoscaler_max: int = 3,
    sustain_s: float = 0.5,
    cooldown_s: float = 2.0,
    headroom: float = 0.7,
    capacity_path: str = "",
    metrics_port: int = -1,
    env_overlay: dict | None = None,
    replica_device: str = "cuda",
    timeout_s: float = _SPAWN_TIMEOUT_S,
) -> list[LocalFrontend]:
    """Boot ``n`` replicated front-end subprocesses that gossip with one
    another (each is configured with the full sibling list as
    ``fleet_peers``), sharing the replica set ``replicas`` plus any
    members that lease in. Ports are pre-reserved so the peer mesh is
    complete from the first boot. The autoscaler, when enabled, runs on
    the FIRST front-end only -- one actuator per fleet, the same
    one-action-at-a-time discipline the scaler itself enforces; the
    replicas it spawns run on ``replica_device``."""
    ports = [_free_port() for _ in range(n)]
    frontends: list[LocalFrontend] = []
    try:
        for i in range(n):
            peers = ",".join(f"localhost:{p}"
                             for j, p in enumerate(ports) if j != i)
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p
            )
            # "{index}" in an overlay value expands per front-end, so
            # siblings can get e.g. distinct RDP_JOURNAL_PATH files
            # (two processes appending one JSONL would race rotation)
            env.update({k: str(v).replace("{index}", str(i))
                        for k, v in (env_overlay or {}).items()})
            argv = [
                sys.executable, "-m",
                "robotic_discovery_platform_tpu_torch.serving.frontend",
                "--worker",
                "--port", str(ports[i]),
                "--replicas", replicas,
                "--peers", peers,
                "--lease-ttl", str(lease_ttl_s),
                "--poll-s", str(poll_s),
                "--window-ms", str(window_ms),
                "--metrics-port", str(metrics_port),
                "--replica-device", replica_device,
            ]
            if elastic:
                argv += ["--elastic"]
            if tracking_uri:
                argv += ["--tracking-uri", tracking_uri]
            if autoscaler and i == 0:
                argv += [
                    "--autoscaler",
                    "--autoscaler-min", str(autoscaler_min),
                    "--autoscaler-max", str(autoscaler_max),
                    "--sustain-s", str(sustain_s),
                    "--cooldown-s", str(cooldown_s),
                    "--headroom", str(headroom),
                ]
                if capacity_path:
                    argv += ["--capacity-path", capacity_path]
            proc, payload = _spawn_worker(argv, env, timeout_s)
            port = int(payload["port"])
            frontends.append(LocalFrontend(
                proc=proc, endpoint=f"localhost:{port}", port=port,
                metrics_port=int(payload.get("metrics_port") or 0),
                argv=argv, env=env,
            ))
            log.info("front-end %d up at localhost:%d (pid %d, "
                     "metrics %s)", i, port, proc.pid,
                     payload.get("metrics_port"))
    except Exception:
        stop_frontends(frontends)
        raise
    return frontends


def stop_frontends(frontends: list[LocalFrontend]) -> None:
    for f in frontends:
        try:
            f.terminate()
        except Exception:  # pragma: no cover - teardown best-effort
            log.exception("front-end %s teardown failed", f.endpoint)


# -- worker entry ------------------------------------------------------------


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Boot one fleet front-end and print its bound port "
                    "as one JSON line (the spawn_local_frontends worker "
                    "protocol)."
    )
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--replicas", default="",
                        help="comma-separated static replica endpoints")
    parser.add_argument("--elastic", action="store_true",
                        help="run a lease registry: replicas may "
                             "Register/Renew/Leave instead of being "
                             "listed in --replicas")
    parser.add_argument("--peers", default="",
                        help="comma-separated sibling front-end "
                             "endpoints to gossip with")
    parser.add_argument("--lease-ttl", type=float, default=10.0)
    parser.add_argument("--poll-s", type=float, default=1.0)
    parser.add_argument("--window-ms", type=float, default=2.0,
                        help="batch window spawned replicas boot with")
    parser.add_argument("--metrics-port", type=int, default=0)
    parser.add_argument("--tracking-uri", default="",
                        help="registry the autoscaler's spawned "
                             "replicas serve from")
    parser.add_argument("--autoscaler", action="store_true")
    parser.add_argument("--autoscaler-min", type=int, default=1)
    parser.add_argument("--autoscaler-max", type=int, default=4)
    parser.add_argument("--sustain-s", type=float, default=5.0)
    parser.add_argument("--cooldown-s", type=float, default=30.0)
    parser.add_argument("--headroom", type=float, default=0.7)
    parser.add_argument("--capacity-path", default="")
    parser.add_argument("--replica-device", default="cuda",
                        choices=("cuda", "cpu"),
                        help="where the autoscaler's spawned replicas "
                             "serve")
    cli = parser.parse_args(argv)

    cfg = ServerConfig(
        address=f"localhost:{cli.port}",
        tracking_uri=cli.tracking_uri,
        metrics_port=cli.metrics_port,
        batch_window_ms=cli.window_ms,
        fleet_replicas=cli.replicas,
        fleet_elastic=cli.elastic,
        fleet_peers=cli.peers,
        fleet_lease_ttl_s=cli.lease_ttl,
        fleet_poll_s=cli.poll_s,
        autoscaler_enabled=cli.autoscaler,
        autoscaler_min_replicas=cli.autoscaler_min,
        autoscaler_max_replicas=cli.autoscaler_max,
        autoscaler_sustain_s=cli.sustain_s,
        autoscaler_cooldown_s=cli.cooldown_s,
        planner_headroom=cli.headroom,
        planner_capacity_path=cli.capacity_path,
    )
    server, frontend = build_frontend(cfg, replica_device=cli.replica_device)
    server.start()
    port = frontend.bound_port or cli.port
    print(json.dumps({
        "port": port,
        "pid": os.getpid(),
        "metrics_port": (frontend.metrics_server.port
                         if frontend.metrics_server is not None else 0),
    }), flush=True)

    stopping = []

    def on_term(signum, frame):  # graceful drain on SIGTERM
        if not stopping:
            stopping.append(signum)
            server.stop(grace=cfg.drain_grace_s)

    signal.signal(signal.SIGTERM, on_term)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=None)
    finally:
        frontend.close()


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        main([a for a in sys.argv[1:] if a != "--worker"])
    else:
        from robotic_discovery_platform_tpu_torch.utils.config import (
            parse_config,
        )

        serve_frontend(parse_config().server)
