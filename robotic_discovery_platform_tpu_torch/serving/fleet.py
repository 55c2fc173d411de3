"""Cross-host serving fleet: membership, placement, and fleet-level SLO
control over per-host replica servers.

The multi-chip router (serving/batching.DeviceRouter) saturates ONE
process's devices; this module is the next ring out -- the Pathways DCN
direction (PAPERS.md): a front-end (serving/frontend.py) fans
``AnalyzeActuatorPerformance`` streams over N per-host replicas, each a
full serving/server.py process with its own chip mesh, reached over
localhost/DCN gRPC. The design deliberately mirrors the chip ring one
level up:

- **Membership is health-gated** on the replicas' existing
  ``grpc.health.v1`` surface: replicas come from a static endpoint list
  (``ServerConfig.fleet_replicas`` / ``RDP_FLEET_REPLICAS``) and are
  polled every ``fleet_poll_s``; a replica whose status flips
  NOT_SERVING (drain, crash, all chips quarantined) drops out of the
  placement ring exactly like a chip drops out of the chip ring, and
  rejoins on recovery through a half-open probe (the per-replica
  :class:`~robotic_discovery_platform_tpu_torch.resilience.CircuitBreaker`
  admits one health probe after ``fleet_breaker_reset_s``; success
  reinstates). A replica reporting ``draining=true`` over the stats RPC
  (a rollout cycle borrowing its chips, serving/rollout.py) leaves
  NEW-stream placement BEFORE health ever flips: a graceful drain, not
  a failover -- its in-flight streams finish normally and the breaker
  never trips.
- **Membership is also elastic**: the same ``rdp.fleet.ReplicaStats``
  RPC surface carries ``Register``/``Renew``/``Leave`` unaries backed
  by a :class:`LeaseRegistry` on the front-end. A replica announces its
  endpoint + metrics port + version on boot (:class:`LeaseClient`,
  wired by server.py from ``RDP_FLEET_REGISTRARS``) and renews on a
  TTL; the router composes these leased members with the static seeds.
  A missed lease expires the member through the EXACT health drop-out
  path above (forced probe failure -> breaker -> quarantined, not
  removed), so a replica respawned on a new port rejoins with zero
  config change by simply registering again; ``Leave`` is the graceful
  path -- the member is treated as draining (the servicer's set_draining semantics) while its
  in-flight streams finish.
- **Placement is least-loaded with ring tie-break**, fed by each
  replica's reported inflight/burn: a lightweight stats RPC
  (:func:`add_replica_stats_to_server`, a JSON-over-gRPC unary the
  replica server registers next to health) carries the replica's
  in-flight streams and its ``rdp_slo_error_budget_burn`` reading, so
  the front-end never needs to scrape HTTP /metrics to place a stream.
- **The reactive SLO control loop is lifted one level**: a
  :class:`FleetController` consumes the per-replica burn gauges and
  rebalances new-stream placement (a weighted ring -- burning replicas
  are de-weighted toward ``fleet_weight_floor``) BEFORE any replica
  browns out; the replica's own reactive controller still handles its
  intra-host knobs.

Clockwork (Gujarati et al., OSDI 2020) is the other parent: replicas are
exclusively owned by this front-end's placement decisions, and
least-loaded pick with ring tie-break is the work-conserving
simplification of its central scheduler for homogeneous single-model
replicas.

The port's copy of the JAX package's module, imports rewritten: the
method paths, the stats payloads and the lease messages are the JAX
package's byte for byte, so a JAX front-end places streams on a port
replica and a port front-end on a JAX replica. It imports no torch: a
fleet front-end routes bytes, it never touches the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable

import grpc

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
)
from robotic_discovery_platform_tpu_torch.resilience import CircuitBreaker
from robotic_discovery_platform_tpu_torch.resilience.breaker import CLOSED
from robotic_discovery_platform_tpu_torch.serving import health as health_lib
from robotic_discovery_platform_tpu_torch.serving.proto import (
    health_pb2,
    vision_grpc,
)
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def resolve_fleet_replicas(configured: str) -> list[str]:
    """The replica endpoint list serving should fan out to: the
    ``RDP_FLEET_REPLICAS`` env var when set, else the configured value
    (``ServerConfig.fleet_replicas``), split on commas with blanks
    dropped. Empty list = no fleet (plain single-host serving)."""
    env = os.environ.get("RDP_FLEET_REPLICAS", "").strip()
    spec = env if env else configured
    return [e.strip() for e in spec.split(",") if e.strip()]


def resolve_fleet_registrars(configured: str) -> list[str]:
    """The front-end endpoints a replica should register its membership
    lease with: ``RDP_FLEET_REGISTRARS`` when set, else the configured
    value (``ServerConfig.fleet_registrars``), comma-split with blanks
    dropped. Empty list = static membership only (no lease client)."""
    env = os.environ.get("RDP_FLEET_REGISTRARS", "").strip()
    spec = env if env else configured
    return [e.strip() for e in spec.split(",") if e.strip()]


def resolve_fleet_elastic(configured: bool) -> bool:
    """Front-end elastic-membership switch: ``RDP_FLEET_ELASTIC`` when
    set ("1"/"true"/"on" enable), else the configured value
    (``ServerConfig.fleet_elastic``). Off = static membership only."""
    env = os.environ.get("RDP_FLEET_ELASTIC", "").strip().lower()
    if env:
        return env in ("1", "true", "yes", "on")
    return bool(configured)


def resolve_fleet_peers(configured: str) -> list[str]:
    """Sibling front-end endpoints this front-end gossips lease +
    placement state with over the stats RPC: ``RDP_FLEET_PEERS`` when
    set, else the configured value (``ServerConfig.fleet_peers``),
    comma-split with blanks dropped."""
    env = os.environ.get("RDP_FLEET_PEERS", "").strip()
    spec = env if env else configured
    return [e.strip() for e in spec.split(",") if e.strip()]


def resolve_fleet_advertise(configured: str, default: str = "") -> str:
    """The endpoint a replica advertises in its lease registration:
    ``RDP_FLEET_ADVERTISE`` when set, else the configured value
    (``ServerConfig.fleet_advertise``), else ``default`` (server.py
    passes ``localhost:<bound port>``)."""
    env = os.environ.get("RDP_FLEET_ADVERTISE", "").strip()
    return env or configured.strip() or default


# -- replica stats RPC -------------------------------------------------------
#
# A lightweight unary the replica server registers next to grpc.health.v1:
# request is empty bytes, response is a UTF-8 JSON object (inflight
# streams, frames served, error-budget burn, chips/quarantined, version,
# draining). Hand-built on grpcio's generic APIs like vision_grpc.py /
# health.py -- no protoc plugin in the image, and a JSON payload keeps the
# schema evolvable without wire churn.

STATS_SERVICE = "rdp.fleet.ReplicaStats"
_STATS_PATH = f"/{STATS_SERVICE}/Get"
_DRAIN_PATH = f"/{STATS_SERVICE}/Drain"
_REGISTER_PATH = f"/{STATS_SERVICE}/Register"
_RENEW_PATH = f"/{STATS_SERVICE}/Renew"
_LEAVE_PATH = f"/{STATS_SERVICE}/Leave"


def _identity_bytes(b):
    return bytes(b or b"")


def _decode_json(payload: bytes) -> dict:
    req = json.loads(payload.decode("utf-8") or "{}")
    return req if isinstance(req, dict) else {}


class ReplicaStatsStub:
    """Client stub: ``stub.Get(b"")`` returns the stats JSON bytes;
    ``stub.Drain(b'{"draining": true}')`` asks a replica for a graceful
    drain (the autoscaler's scale-down lever -- remote ``set_draining``,
    the servicer's set_draining semantics: held out of NEW-stream placement, in-flight streams
    finish, health stays SERVING)."""

    def __init__(self, channel: grpc.Channel):
        self.Get = channel.unary_unary(
            _STATS_PATH,
            request_serializer=_identity_bytes,
            response_deserializer=_identity_bytes,
        )
        self.Drain = channel.unary_unary(
            _DRAIN_PATH,
            request_serializer=_identity_bytes,
            response_deserializer=_identity_bytes,
        )


class FleetLeaseStub:
    """Client stub for the membership-lease unaries a front-end serves.
    Requests/responses are UTF-8 JSON objects like the stats RPC."""

    def __init__(self, channel: grpc.Channel):
        kw = dict(request_serializer=_identity_bytes,
                  response_deserializer=_identity_bytes)
        self.Register = channel.unary_unary(_REGISTER_PATH, **kw)
        self.Renew = channel.unary_unary(_RENEW_PATH, **kw)
        self.Leave = channel.unary_unary(_LEAVE_PATH, **kw)


def add_fleet_rpcs_to_server(
        server, *, stats_provider: Callable[[], dict] | None = None,
        registry: "LeaseRegistry | None" = None,
        drain: Callable[[bool], None] | None = None) -> None:
    """Register whichever ``rdp.fleet.ReplicaStats`` methods this
    process serves, as ONE generic handler: ``Get`` (stats -- replicas
    and front-ends), ``Drain`` (remote graceful drain -- replicas), and
    ``Register``/``Renew``/``Leave`` (membership leases -- front-ends
    holding a :class:`LeaseRegistry`)."""

    handlers: dict = {}
    hkw = dict(request_deserializer=_identity_bytes,
               response_serializer=_identity_bytes)

    if stats_provider is not None:
        def get(request, context):
            return json.dumps(stats_provider()).encode("utf-8")

        handlers["Get"] = grpc.unary_unary_rpc_method_handler(get, **hkw)

    if drain is not None:
        def do_drain(request, context):
            req = _decode_json(request)
            drain(bool(req.get("draining", True)))
            return json.dumps({"ok": True}).encode("utf-8")

        handlers["Drain"] = grpc.unary_unary_rpc_method_handler(
            do_drain, **hkw)

    if registry is not None:
        def do_register(request, context):
            req = _decode_json(request)
            endpoint = str(req.get("endpoint", "")).strip()
            if not endpoint:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "lease registration needs an endpoint")
            resp = registry.register(
                endpoint,
                metrics_port=req.get("metrics_port", 0),
                version=req.get("version", ""),
            )
            return json.dumps(resp).encode("utf-8")

        def do_renew(request, context):
            req = _decode_json(request)
            resp = registry.renew(str(req.get("endpoint", "")).strip())
            if resp is None:
                # refused: unknown endpoint, lease already expired/left,
                # or the renew lost the race with expiry. The client's
                # recovery is always the same -- re-register.
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              "no active lease; re-register")
            return json.dumps(resp).encode("utf-8")

        def do_leave(request, context):
            req = _decode_json(request)
            resp = registry.leave(str(req.get("endpoint", "")).strip())
            return json.dumps(resp).encode("utf-8")

        handlers["Register"] = grpc.unary_unary_rpc_method_handler(
            do_register, **hkw)
        handlers["Renew"] = grpc.unary_unary_rpc_method_handler(
            do_renew, **hkw)
        handlers["Leave"] = grpc.unary_unary_rpc_method_handler(
            do_leave, **hkw)

    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(STATS_SERVICE, handlers),)
    )


def add_replica_stats_to_server(
        server, provider: Callable[[], dict],
        drain: Callable[[bool], None] | None = None) -> None:
    """Register the stats RPC (and optionally the remote-drain unary);
    ``provider`` returns the stats dict (the serving layer passes
    ``VisionAnalysisService.replica_stats``)."""
    add_fleet_rpcs_to_server(server, stats_provider=provider, drain=drain)


def fetch_replica_stats(stub: ReplicaStatsStub,
                        timeout_s: float | None = None) -> dict:
    payload = stub.Get(b"", timeout=timeout_s)
    stats = json.loads(payload.decode("utf-8") or "{}")
    if not isinstance(stats, dict):
        raise ValueError(f"replica stats payload is {type(stats).__name__},"
                         " not an object")
    return stats


# -- membership leases -------------------------------------------------------
#
# The elastic half of membership: replicas announce themselves and renew
# on a TTL; the front-end's registry runs each endpoint's lease through a
# tiny three-state machine. Expiry is the SIGKILL/partition path (the
# router forces the member through the health drop-out -> breaker
# quarantine it already survives); Leave is the graceful path (treated as
# the servicer's draining flag). Every transition bumps its counter, journals
# a fleet.lease event, and feeds the injectable observer the explorer
# uses to witness edge coverage -- the breaker's set_observer idiom.

LEASE_ACTIVE = "active"
LEASE_EXPIRED = "expired"
LEASE_LEFT = "left"
#: the lease machine's whole vocabulary, in lifecycle order
LEASE_STATES = (LEASE_ACTIVE, LEASE_EXPIRED, LEASE_LEFT)

#: observer hook for lease transitions (endpoint, frm, to) -- injectable
#: so analysis/explore.py witnesses edges without patching internals
_lease_observer: Callable[[str, str, str], None] | None = None


def set_lease_observer(
        fn: Callable[[str, str, str], None] | None) -> None:
    global _lease_observer
    _lease_observer = fn


class Lease:
    """One endpoint's membership lease. State mutations go through
    :meth:`_transition` (counter + journal + observer); the registry is
    the only caller and holds its lock across them so readers never see
    a half-applied renewal."""

    def __init__(self, endpoint: str, *, ttl_s: float, now: float,
                 metrics_port: int = 0, version: str = ""):
        self.endpoint = endpoint
        self.ttl_s = float(ttl_s)
        self.metrics_port = int(metrics_port or 0)
        self.version = str(version or "")
        self.registered_at = now
        self.expires_at = now + self.ttl_s
        self.renewals = 0
        self.state_changed_at = now
        self._state = LEASE_ACTIVE

    @property
    def state(self) -> str:
        return self._state

    def _transition(self, to: str, now: float, reason: str = "") -> None:
        frm = self._state
        self._state = to
        self.state_changed_at = now
        obs.FLEET_LEASE_TRANSITIONS.labels(state=to).inc()
        journal_lib.JOURNAL.append(
            events.FLEET_LEASE, endpoint=self.endpoint, frm=frm, to=to,
            reason=reason,
        )
        if _lease_observer is not None:
            _lease_observer(self.endpoint, frm, to)

    def refresh(self, now: float, *, ttl_s: float, metrics_port: int = 0,
                version: str = "") -> None:
        """A (re-)registration landed: refresh the advertisement and
        deadline, and re-arm a non-active lease back to active -- the
        respawned-on-a-new-port rejoin edge. A double-register of a
        live endpoint takes no transition (just a longer deadline)."""
        late = now >= self.expires_at
        self.ttl_s = float(ttl_s)
        self.metrics_port = int(metrics_port or 0)
        self.version = str(version or "")
        self.registered_at = now
        self.expires_at = now + self.ttl_s
        if self._state != LEASE_ACTIVE:
            self._transition(
                LEASE_ACTIVE, now,
                reason="re-register (late)" if late else "re-register",
            )

    def expire(self, now: float) -> bool:
        """Take the clocked expiry edge if the deadline has passed."""
        if self._state == LEASE_ACTIVE and now >= self.expires_at:
            self._transition(LEASE_EXPIRED, now,
                             reason=f"missed ttl {self.ttl_s:g}s")
            return True
        return False

    def depart(self, now: float) -> bool:
        """Graceful Leave: only an active lease can leave (an expired
        member sending Leave is already gone; it must re-register)."""
        if self._state == LEASE_ACTIVE:
            self._transition(LEASE_LEFT, now, reason="leave")
            return True
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Lease({self.endpoint!r}, state={self._state}, "
                f"renewals={self.renewals})")


class LeaseRegistry:
    """The front-end's lease table: endpoint -> :class:`Lease`, TTL'd.

    ``register``/``renew``/``leave`` back the Register/Renew/Leave
    unaries; the router's poll loop calls :meth:`sweep` each tick so a
    member that stops renewing expires within one poll of its deadline.
    A renew that arrives at-or-after the deadline is REFUSED rather than
    racing the sweep -- the sweep owns the expiry transition, and the
    refused client re-registers (one spurious re-register beats a lease
    that flaps between alive and expired depending on thread timing)."""

    def __init__(self, *, ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = max(0.1, float(ttl_s))
        self._clock = clock
        self._lock = checked_lock("fleet.leases")
        self._leases: dict[str, Lease] = {}  # guarded_by: _lock

    # -- the lease RPCs ------------------------------------------------------

    def register(self, endpoint: str, *, metrics_port: int = 0,
                 version: str = "") -> dict:
        """Accept a (re-)registration. A double-register of a live
        endpoint just refreshes its deadline and advertisement; an
        expired or left endpoint transitions back to active -- the
        respawned-on-a-new-port rejoin needs nothing else."""
        endpoint = str(endpoint).strip()
        if not endpoint:
            raise ValueError("lease registration needs an endpoint")
        now = self._clock()
        with self._lock:
            lease = self._leases.get(endpoint)
            if lease is None:
                lease = Lease(endpoint, ttl_s=self.ttl_s, now=now,
                              metrics_port=metrics_port, version=version)
                self._leases[endpoint] = lease
                journal_lib.JOURNAL.append(
                    events.FLEET_LEASE, endpoint=endpoint, frm="",
                    to=LEASE_ACTIVE, reason="register",
                )
            else:
                lease.refresh(now, ttl_s=self.ttl_s,
                              metrics_port=metrics_port, version=version)
        obs.FLEET_LEASE_REGISTRATIONS.inc()
        self._publish()
        return {"ok": True, "ttl_s": self.ttl_s}

    def renew(self, endpoint: str) -> dict | None:
        """Extend an active lease; ``None`` refuses (unknown, not
        active, or the renew lost the race with the expiry deadline on
        the shared clock -- the client must re-register)."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(str(endpoint).strip())
            if lease is None or lease.state != LEASE_ACTIVE:
                return None
            if now >= lease.expires_at:
                journal_lib.JOURNAL.append(
                    events.FLEET_LEASE, endpoint=lease.endpoint,
                    frm=lease.state, to=lease.state,
                    reason="renew_refused (deadline passed)",
                )
                return None
            lease.expires_at = now + self.ttl_s
            lease.renewals += 1
        obs.FLEET_LEASE_RENEWALS.inc()
        return {"ok": True, "ttl_s": self.ttl_s}

    def leave(self, endpoint: str) -> dict:
        """Graceful departure: the member keeps serving its in-flight
        streams but leaves NEW-stream placement (the router treats a
        left lease as the servicer's draining flag)."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(str(endpoint).strip())
            if lease is not None:
                lease.depart(now)
        self._publish()
        return {"ok": True}

    def sweep(self) -> list[str]:
        """Expire every active lease whose deadline passed; returns the
        endpoints expired this call. The router runs this each poll
        tick, so expiry lands within ``poll_s`` of the deadline."""
        now = self._clock()
        expired: list[str] = []
        with self._lock:
            for lease in self._leases.values():
                if lease.expire(now):
                    expired.append(lease.endpoint)
        for _ in expired:
            obs.FLEET_LEASE_EXPIRIES.inc()
        if expired:
            self._publish()
        return expired

    # -- readers / maintenance ----------------------------------------------

    def state_of(self, endpoint: str) -> str | None:
        with self._lock:
            lease = self._leases.get(endpoint)
            return lease.state if lease is not None else None

    def get(self, endpoint: str) -> Lease | None:
        with self._lock:
            return self._leases.get(endpoint)

    def endpoints(self, state: str | None = None) -> list[str]:
        with self._lock:
            return [ep for ep, lease in self._leases.items()
                    if state is None or lease.state == state]

    def snapshot(self) -> dict:
        """The gossip payload front-ends exchange over their stats RPC:
        per-endpoint lease state with REMAINING ttl (never absolute
        monotonic deadlines -- each process has its own clock zero)."""
        now = self._clock()
        with self._lock:
            return {
                ep: {
                    "state": lease.state,
                    "expires_in_s": max(0.0, lease.expires_at - now),
                    "metrics_port": lease.metrics_port,
                    "version": lease.version,
                    "renewals": lease.renewals,
                }
                for ep, lease in self._leases.items()
            }

    def adopt(self, endpoint: str, *, expires_in_s: float,
              metrics_port: int = 0, version: str = "") -> bool:
        """Merge one gossiped ACTIVE lease from a sibling front-end:
        unknown endpoints are created, known active ones keep the later
        of the two deadlines. Never resurrects a locally expired/left
        lease -- the member's own re-register is the only way back."""
        endpoint = str(endpoint).strip()
        remaining = min(max(0.0, float(expires_in_s)), self.ttl_s)
        if not endpoint or remaining <= 0.0:
            return False
        now = self._clock()
        adopted = False
        with self._lock:
            lease = self._leases.get(endpoint)
            if lease is None:
                lease = Lease(endpoint, ttl_s=self.ttl_s, now=now,
                              metrics_port=metrics_port, version=version)
                lease.expires_at = now + remaining
                self._leases[endpoint] = lease
                journal_lib.JOURNAL.append(
                    events.FLEET_LEASE, endpoint=endpoint, frm="",
                    to=LEASE_ACTIVE, reason="gossip_adopt",
                )
                adopted = True
            elif lease.state == LEASE_ACTIVE:
                lease.expires_at = max(lease.expires_at, now + remaining)
        if adopted:
            self._publish()
        return adopted

    def force_expire(self, endpoint: str) -> None:
        """Rewind one lease's deadline to NOW (tests + the explorer:
        the next sweep takes the honest clocked expiry edge)."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(endpoint)
            if lease is not None:
                lease.expires_at = now

    def prunable(self, max_age_s: float) -> list[str]:
        """Endpoints whose lease has sat expired/left longer than
        ``max_age_s`` -- the router forgets these entirely (channel
        closed, probe stopped) once their in-flight count hits zero."""
        now = self._clock()
        with self._lock:
            return [
                ep for ep, lease in self._leases.items()
                if lease.state != LEASE_ACTIVE
                and now - lease.state_changed_at > max_age_s
            ]

    def drop(self, endpoint: str) -> None:
        with self._lock:
            self._leases.pop(endpoint, None)
        self._publish()

    def _publish(self) -> None:
        with self._lock:
            counts = dict.fromkeys(LEASE_STATES, 0)
            for lease in self._leases.values():
                counts[lease.state] = counts.get(lease.state, 0) + 1
        for state, n in counts.items():
            obs.FLEET_LEASE_MEMBERS.labels(state=state).set(n)


class LeaseClient:
    """Replica-side lease loop: register with every configured registrar
    (front-end) on boot, renew at a third of the TTL, and fall back to
    re-registering whenever a renew is refused (the registrar restarted,
    or we lost the race with our own deadline). ``leave`` rides the
    graceful-drain path (server.py fires it from ``drain()``).

    All RPCs are best-effort per registrar: one unreachable front-end
    never blocks the lease with its siblings."""

    def __init__(self, registrars: list[str], *, endpoint: str,
                 metrics_port: int = 0, version: str = "",
                 ttl_s: float = 10.0,
                 channel_factory=grpc.insecure_channel,
                 rpc_timeout_s: float = 2.0):
        self.registrars = [r.strip() for r in registrars if r.strip()]
        self.endpoint = endpoint
        self.metrics_port = int(metrics_port or 0)
        self.version = str(version or "")
        self.ttl_s = max(0.1, float(ttl_s))
        self.rpc_timeout_s = rpc_timeout_s
        self._channel_factory = channel_factory
        self._channels: dict[str, grpc.Channel] = {}
        self._stubs: dict[str, FleetLeaseStub] = {}
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self.registrations = 0
        self.renewals = 0

    def _stub(self, registrar: str) -> FleetLeaseStub:
        if registrar not in self._stubs:
            channel = self._channel_factory(registrar)
            self._channels[registrar] = channel
            self._stubs[registrar] = FleetLeaseStub(channel)
        return self._stubs[registrar]

    def _payload(self) -> bytes:
        return json.dumps({
            "endpoint": self.endpoint,
            "metrics_port": self.metrics_port,
            "version": self.version,
        }).encode("utf-8")

    def register(self) -> int:
        """Register with every registrar; returns how many accepted."""
        ok = 0
        for registrar in self.registrars:
            try:
                self._stub(registrar).Register(
                    self._payload(), timeout=self.rpc_timeout_s)
                ok += 1
            except Exception as exc:  # noqa: BLE001 - per-registrar
                log.debug("lease register with %s failed: %s",
                          registrar, exc)
        if ok:
            self.registrations += 1
        return ok

    def renew_once(self) -> int:
        """One renew round; a refused/failed renew immediately falls
        back to Register on that registrar. Returns renews accepted."""
        ok = 0
        for registrar in self.registrars:
            try:
                self._stub(registrar).Renew(
                    self._payload(), timeout=self.rpc_timeout_s)
                ok += 1
            except Exception as exc:  # noqa: BLE001 - re-register path
                log.debug("lease renew with %s refused/failed (%s); "
                          "re-registering", registrar, exc)
                try:
                    self._stub(registrar).Register(
                        self._payload(), timeout=self.rpc_timeout_s)
                    self.registrations += 1
                except Exception as exc2:  # noqa: BLE001
                    log.debug("lease re-register with %s failed: %s",
                              registrar, exc2)
        if ok:
            self.renewals += 1
        return ok

    def leave(self) -> None:
        for registrar in self.registrars:
            try:
                self._stub(registrar).Leave(
                    self._payload(), timeout=self.rpc_timeout_s)
            except Exception as exc:  # noqa: BLE001 - best-effort
                log.debug("lease leave with %s failed: %s",
                          registrar, exc)

    def start(self) -> None:
        if self._thread is not None or not self.registrars:
            return
        self.register()
        self._stop = threading.Event()
        interval = max(0.05, self.ttl_s / 3.0)

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.renew_once()
                except Exception:  # pragma: no cover - keep renewing
                    log.exception("lease renew round failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-lease", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for channel in self._channels.values():
            channel.close()
        self._channels.clear()
        self._stubs.clear()


class PeerGossip:
    """Coordinator-free shared state between replicated front-ends.

    Each front-end already SERVES a stats RPC of its own (role
    "frontend": its lease table plus per-replica placement loads). This
    is the consuming half: poll every sibling's stats RPC and

    - **adopt** ACTIVE lease advertisements we have not heard directly
      (a replica that registered with sibling A becomes placeable on
      sibling B within one gossip round -- no shared store, no
      coordinator, and :meth:`LeaseRegistry.adopt` never resurrects a
      lease this front-end saw expire or leave);
    - **fold** the siblings' per-replica in-flight counts into this
      router's placement view (:meth:`FleetRouter.set_external_load`),
      so N front-ends placing independently stop dogpiling the replica
      each one sees as idle.

    Best-effort per peer: an unreachable sibling contributes nothing
    this round and its previously gossiped load ages out on the next
    successful round (set_external_load replaces, never accumulates)."""

    def __init__(self, peers: list[str], *, registry: LeaseRegistry,
                 router: "FleetRouter", poll_s: float = 1.0,
                 rpc_timeout_s: float = 2.0,
                 channel_factory=grpc.insecure_channel):
        self.peers = [p.strip() for p in peers if p.strip()]
        self.registry = registry
        self.router = router
        self.poll_s = max(0.05, float(poll_s))
        self.rpc_timeout_s = rpc_timeout_s
        self._channel_factory = channel_factory
        self._channels: dict[str, grpc.Channel] = {}
        self._stubs: dict[str, ReplicaStatsStub] = {}
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self.rounds = 0
        self.adopted_total = 0

    def _stub(self, peer: str) -> ReplicaStatsStub:
        if peer not in self._stubs:
            channel = self._channel_factory(peer)
            self._channels[peer] = channel
            self._stubs[peer] = ReplicaStatsStub(channel)
        return self._stubs[peer]

    def poll_once(self) -> int:
        """One gossip round; returns how many peers answered."""
        reached = 0
        loads: dict[str, int] = {}
        for peer in self.peers:
            try:
                payload = _decode_json(
                    self._stub(peer).Get(b"", timeout=self.rpc_timeout_s))
            except Exception as exc:  # noqa: BLE001 - per-peer
                log.debug("gossip with %s failed: %s", peer, exc)
                continue
            reached += 1
            for ep, lease in (payload.get("leases") or {}).items():
                if lease.get("state") != LEASE_ACTIVE:
                    continue
                if self.registry.adopt(
                        ep,
                        expires_in_s=float(lease.get("expires_in_s", 0.0)),
                        metrics_port=int(lease.get("metrics_port", 0)),
                        version=str(lease.get("version", ""))):
                    self.adopted_total += 1
            for ep, n in (payload.get("replica_loads") or {}).items():
                try:
                    loads[ep] = loads.get(ep, 0) + int(n)
                except (TypeError, ValueError):
                    continue
        self.rounds += 1
        self.router.set_external_load(loads)
        return reached

    def start(self) -> None:
        if self._thread is not None or not self.peers:
            return
        self._stop = threading.Event()
        # Boot-time seed (registrar quorum hygiene): a front-end that
        # (re)starts with an empty lease table would otherwise place
        # blind for up to poll_s while members it never heard of renew
        # elsewhere -- the ~1 TTL blind spot after a registrar restart.
        # One synchronous round now adopts every sibling-advertised
        # ACTIVE lease before the first stream is placed; adopt still
        # never resurrects a lease THIS front-end saw expire or leave.
        try:
            self.poll_once()
        except Exception:  # noqa: BLE001 - seed is best-effort
            log.exception("boot-time gossip seed failed")

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception:  # pragma: no cover - keep gossiping
                    log.exception("gossip round failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-gossip", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for channel in self._channels.values():
            channel.close()
        self._channels.clear()
        self._stubs.clear()


# -- placement ---------------------------------------------------------------


def _least_loaded(loads, start: int = 0) -> int:
    """Index of the minimum of ``loads``, ties broken in ring order from
    ``start`` -- the JAX package's parallel/mesh.least_loaded, re-stated
    here so the front-end imports nothing heavy to walk a ring."""
    n = len(loads)
    best = start % n
    for off in range(1, n):
        i = (start + off) % n
        if loads[i] < loads[best]:
            best = i
    return best


class Replica:
    """One fleet member: endpoint, lazy gRPC plumbing, and the live state
    placement reads (health verdict, breaker, inflight, burn, weight).

    The channel/stubs are created on first use so placement units can
    drive a router over fake replicas without any sockets."""

    def __init__(self, endpoint: str, *, breaker_failures: int = 2,
                 breaker_reset_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 channel_factory=grpc.insecure_channel):
        self.endpoint = endpoint
        self.breaker = CircuitBreaker(
            failure_threshold=max(1, breaker_failures),
            reset_timeout_s=breaker_reset_s,
            name=f"replica:{endpoint}",
            clock=clock,
        )
        self._channel_factory = channel_factory
        self._channel: grpc.Channel | None = None
        self._stub = None
        self._health_stub = None
        self._stats_stub = None
        #: last health-poll verdict (SERVING and reachable)
        self.serving = False
        #: replica reports draining=true over the stats RPC: healthy but
        #: asking for no NEW streams (rollout drain / pre-stop). Distinct
        #: from a health drop-out on purpose -- in-flight streams finish
        #: normally instead of failing over, and the breaker never trips.
        self.draining = False
        #: front-end-placed streams currently open on this replica
        self.inflight = 0
        #: streams SIBLING front-ends report placed here (gossip-fed;
        #: folds into effective_load so N replicated front-ends don't
        #: all dogpile the replica each sees as idle)
        self.external = 0
        #: frames relayed through this replica (front-end count)
        self.frames = 0
        #: streams ever placed here
        self.placements = 0
        #: last scraped rdp_slo_error_budget_burn (0.0 when unknown)
        self.burn = 0.0
        #: FleetController placement weight (1.0 = full share)
        self.weight = 1.0
        #: last full stats payload (diagnostics)
        self.stats: dict = {}
        #: metrics-exposition port the replica advertised over the stats
        #: RPC (0 = none); the federation/trace-stitch scrapes need it
        self.metrics_port = 0

    @property
    def metrics_base_url(self) -> str | None:
        """Base URL of this replica's metrics server (federated scrape +
        /debug/spans stitching target), once the stats RPC has
        advertised a port."""
        if not self.metrics_port or self.metrics_port <= 0:
            return None
        host = self.endpoint.rsplit(":", 1)[0] or "localhost"
        return f"http://{host}:{self.metrics_port}"

    # -- wiring (lazy) ------------------------------------------------------

    @property
    def channel(self) -> grpc.Channel:
        if self._channel is None:
            self._channel = self._channel_factory(self.endpoint)
        return self._channel

    @property
    def stub(self) -> vision_grpc.VisionAnalysisServiceStub:
        if self._stub is None:
            self._stub = vision_grpc.VisionAnalysisServiceStub(self.channel)
        return self._stub

    @property
    def health_stub(self) -> health_lib.HealthStub:
        if self._health_stub is None:
            self._health_stub = health_lib.HealthStub(self.channel)
        return self._health_stub

    @property
    def stats_stub(self) -> ReplicaStatsStub:
        if self._stats_stub is None:
            self._stats_stub = ReplicaStatsStub(self.channel)
        return self._stats_stub

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
            self._stub = self._health_stub = self._stats_stub = None

    # -- placement state ----------------------------------------------------

    @property
    def placeable(self) -> bool:
        """In the ring: last health probe said SERVING, the breaker is
        closed (an open breaker = quarantined until its half-open probe
        succeeds), and the replica is not asking for a graceful drain --
        ``draining`` takes it out of NEW-stream placement BEFORE health
        ever flips, so its in-flight streams run to completion instead
        of failing over."""
        return (self.serving and self.breaker.state == CLOSED
                and not self.draining)

    @property
    def effective_load(self) -> float:
        """What least-loaded pick compares: in-flight streams (our own
        placements plus what sibling front-ends gossip they placed
        here) scaled by the controller's weight (a de-weighted replica
        looks busier than its raw count, shifting new streams away)."""
        return (self.inflight + self.external) / max(self.weight, 1e-6)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Replica({self.endpoint!r}, serving={self.serving}, "
                f"inflight={self.inflight}, burn={self.burn:.2f}, "
                f"weight={self.weight:.2f})")


class FleetController:
    """The reactive SLO control loop lifted to fleet level: consume each
    replica's error-budget burn and rebalance NEW-stream placement (the
    weighted ring) before any replica browns out.

    Pure function of the scraped burn values -- no thread of its own; the
    router's poll loop calls :meth:`rebalance` after every stats refresh,
    and tests call it directly with injected replicas. A replica's weight
    is 1.0 while its burn stays at or under ``burn_high`` and decays as
    ``burn_high / burn`` above it, floored at ``weight_floor`` so a
    burning replica keeps serving enough traffic to report recovery (the
    same starve-the-signal reasoning as brownout rung 3's duty cycle)."""

    #: weight moves smaller than this are ignored (gauge/log hygiene)
    DEADBAND = 0.05

    def __init__(self, *, burn_high: float = 0.8,
                 weight_floor: float = 0.1):
        if not 0.0 < weight_floor <= 1.0:
            raise ValueError("weight_floor must be in (0, 1]")
        self.burn_high = burn_high
        self.weight_floor = weight_floor
        self.actions_total = 0

    def target_weight(self, burn: float) -> float:
        if burn <= self.burn_high:
            return 1.0
        return max(self.weight_floor, self.burn_high / burn)

    def rebalance(self, replicas: list[Replica]) -> None:
        for r in replicas:
            target = self.target_weight(r.burn)
            if abs(target - r.weight) <= self.DEADBAND and target != 1.0:
                continue
            if target != r.weight:
                action = ("deweight" if target < r.weight else "reweight")
                if abs(target - r.weight) > self.DEADBAND:
                    self.actions_total += 1
                    obs.FLEET_CONTROLLER_ACTIONS.labels(action=action).inc()
                    log.info(
                        "fleet controller: %s %s weight %.2f -> %.2f "
                        "(burn %.2f)", action, r.endpoint, r.weight,
                        target, r.burn,
                    )
                r.weight = target
            obs.FLEET_REPLICA_WEIGHT.labels(replica=r.endpoint).set(
                r.weight)


class FleetRouter:
    """Health-gated membership + least-loaded stream placement over the
    static replica list.

    One poll thread drives the whole control surface: per-replica health
    probe (the breaker's half-open probe when quarantined), stats scrape
    (inflight/burn), controller rebalance, membership metrics, and the
    ``on_membership(live_count)`` callback the front-end uses to flip its
    own readiness. ``poll_once`` is public so tests drive membership
    deterministically without the thread."""

    #: expired/left leases older than this many TTLs are forgotten
    #: entirely (replica removed, channel closed) once idle
    PRUNE_TTLS = 10.0

    def __init__(self, endpoints: list[str], *, poll_s: float = 1.0,
                 probe_timeout_s: float = 1.0, breaker_failures: int = 2,
                 breaker_reset_s: float = 5.0,
                 controller: FleetController | None = None,
                 on_membership: Callable[[int], None] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 channel_factory=grpc.insecure_channel,
                 registry: LeaseRegistry | None = None):
        if not endpoints and registry is None:
            raise ValueError("a fleet needs at least one replica endpoint")
        self.replicas = [
            Replica(ep, breaker_failures=breaker_failures,
                    breaker_reset_s=breaker_reset_s, clock=clock,
                    channel_factory=channel_factory)
            for ep in endpoints
        ]
        #: the static seeds: never pruned, membership is purely
        #: health-gated for them even if one also registers a lease
        self._static = frozenset(endpoints)
        self.registry = registry
        self.poll_s = poll_s
        self.probe_timeout_s = probe_timeout_s
        self.controller = controller
        self.on_membership = on_membership
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = breaker_reset_s
        self._clock = clock
        self._channel_factory = channel_factory
        self._lock = checked_lock("fleet.router")
        self._ring_start = 0  # guarded_by: _lock
        self._last_live = -1  # guarded_by: _lock
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        #: stream-level failovers observed (reroutes + error-completions)
        self.failovers_total = 0  # guarded_by: _lock
        self.failover_frames_rerouted = 0  # guarded_by: _lock
        self.failover_frames_error_completed = 0  # guarded_by: _lock

    # -- membership ----------------------------------------------------------

    def poll_once(self) -> int:
        """One membership tick; returns the live (placeable) count."""
        if self.registry is not None:
            self.registry.sweep()
            self.sync_leases()
        for r in list(self.replicas):
            healthy = False
            exc: BaseException | None = None
            if self._lease_expired(r.endpoint):
                # a missed lease IS a failed probe: the member stopped
                # renewing (SIGKILL, partition, wedged renew loop), so it
                # takes the exact NOT_SERVING drop-out path below even if
                # a zombie socket still answers health checks. It stays
                # in the replica list -- quarantined, not dropped -- and a
                # re-register readmits it through the half-open probe.
                exc = RuntimeError(
                    f"lease expired ({r.endpoint} stopped renewing)")
            else:
                try:
                    resp = r.health_stub.Check(
                        health_pb2.HealthCheckRequest(service=""),
                        timeout=self.probe_timeout_s,
                    )
                    healthy = resp.status == health_lib.SERVING
                    if not healthy:
                        exc = RuntimeError(
                            f"health status {resp.status} (not SERVING)")
                except Exception as e:  # noqa: BLE001 - any probe failure
                    exc = e
            was = r.placeable
            if healthy:
                r.serving = True
                # a healthy probe is the half-open "probe stream": only a
                # breaker that ADMITS one may close on it, so a crashy
                # replica must hold healthy through its reset timeout
                # before rejoining the ring
                if r.breaker.state == CLOSED or r.breaker.allow():
                    r.breaker.record_success()
            else:
                r.serving = False
                r.breaker.record_failure(exc)
            if r.placeable != was:
                log.warning(
                    "fleet membership: replica %s %s (%s)",
                    r.endpoint,
                    "joined" if r.placeable else "dropped out",
                    "healthy" if healthy else exc,
                )
                journal_lib.JOURNAL.append(
                    events.FLEET_MEMBERSHIP,
                    replica=r.endpoint,
                    state="joined" if r.placeable else "dropped",
                    reason="healthy" if healthy else str(exc),
                )
            if r.serving:
                self._scrape_stats(
                    r, lease_left=self._lease_left(r.endpoint))
            else:
                obs.FLEET_REPLICA_BURN.labels(replica=r.endpoint).set(0.0)
        if self.controller is not None:
            self.controller.rebalance(list(self.replicas))
        if self.registry is not None:
            self._prune_leases()
        return self._publish_membership()

    def _lease_expired(self, endpoint: str) -> bool:
        return (self.registry is not None
                and self.registry.state_of(endpoint) == LEASE_EXPIRED)

    def _lease_left(self, endpoint: str) -> bool:
        return (self.registry is not None
                and self.registry.state_of(endpoint) == LEASE_LEFT)

    def sync_leases(self) -> None:
        """Fold newly ACTIVE leased endpoints into the probe set. Public
        so tests and the explorer admit a member without waiting for (or
        racing) the poll thread; idempotent, and the poll loop runs it
        every tick anyway."""
        if self.registry is None:
            return
        with self._lock:
            known = {r.endpoint for r in self.replicas}
        for ep in self.registry.endpoints(LEASE_ACTIVE):
            if ep in known:
                continue
            r = Replica(ep, breaker_failures=self._breaker_failures,
                        breaker_reset_s=self._breaker_reset_s,
                        clock=self._clock,
                        channel_factory=self._channel_factory)
            lease = self.registry.get(ep)
            if lease is not None and lease.metrics_port:
                r.metrics_port = lease.metrics_port
            with self._lock:
                self.replicas.append(r)
            log.info("fleet membership: leased replica %s joined the "
                     "probe set", ep)

    def _prune_leases(self) -> None:
        """Forget members whose lease has sat expired/left for
        ``PRUNE_TTLS`` TTLs: quarantine is for members expected back, a
        week-old lease is config debt. Static seeds just shed the stale
        lease and return to plain health gating."""
        for ep in self.registry.prunable(
                self.PRUNE_TTLS * self.registry.ttl_s):
            if ep in self._static:
                self.registry.drop(ep)
                continue
            removed: Replica | None = None
            with self._lock:
                for i, r in enumerate(self.replicas):
                    if r.endpoint == ep and r.inflight == 0:
                        removed = self.replicas.pop(i)
                        break
            if removed is not None:
                removed.close()
                self.registry.drop(ep)
                log.info("fleet membership: pruned long-dead leased "
                         "replica %s", ep)
                journal_lib.JOURNAL.append(
                    events.FLEET_MEMBERSHIP, replica=ep, state="pruned",
                    reason="lease stale beyond prune horizon",
                )

    def set_external_load(self, loads: dict[str, int]) -> None:
        """Gossip feed: streams sibling front-ends report placed on each
        replica (an absolute snapshot, not a delta), folded into
        ``effective_load`` so replicated front-ends don't all dogpile
        the replica each one sees as locally idle."""
        with self._lock:
            for r in self.replicas:
                r.external = max(0, int(loads.get(r.endpoint, 0)))

    @property
    def static_endpoints(self) -> frozenset:
        """The configured seeds: health-gated only, never pruned, and
        never the autoscaler's scale-down pick."""
        return self._static

    def placement_loads(self) -> dict[str, int]:
        """This front-end's own placements per replica -- the load half
        of the gossip payload siblings fold into their rings."""
        with self._lock:
            return {r.endpoint: r.inflight for r in self.replicas}

    def _scrape_stats(self, r: Replica, lease_left: bool = False) -> None:
        """Advisory: a failed scrape never drops a healthy replica --
        placement just keeps using the front-end's own inflight count and
        the last known burn. ``lease_left`` ORs into draining: a member
        that sent Leave is treated exactly like one reporting
        draining=true, even before its own flag flips."""
        try:
            stats = fetch_replica_stats(r.stats_stub, self.probe_timeout_s)
        except Exception as exc:  # noqa: BLE001
            log.debug("stats scrape of %s failed: %s", r.endpoint, exc)
            if lease_left and not r.draining:
                r.draining = True
                journal_lib.JOURNAL.append(
                    events.FLEET_DRAIN, replica=r.endpoint,
                    state="draining",
                )
            return
        r.stats = stats
        try:
            r.burn = float(stats.get("burn", 0.0))
        except (TypeError, ValueError):
            r.burn = 0.0
        try:
            r.metrics_port = int(stats.get("metrics_port", 0) or 0)
        except (TypeError, ValueError):
            r.metrics_port = 0
        was_draining = r.draining
        r.draining = bool(stats.get("draining", False)) or lease_left
        if r.draining != was_draining:
            log.info(
                "fleet membership: replica %s %s (graceful drain, health "
                "still SERVING)", r.endpoint,
                "draining -- out of new-stream placement" if r.draining
                else "un-drained -- placeable again",
            )
            journal_lib.JOURNAL.append(
                events.FLEET_DRAIN, replica=r.endpoint,
                state="draining" if r.draining else "undrained",
            )
        obs.FLEET_REPLICA_BURN.labels(replica=r.endpoint).set(r.burn)

    def _publish_membership(self) -> int:
        live = self.live_count
        obs.FLEET_REPLICAS_LIVE.set(live)
        obs.FLEET_REPLICAS_QUARANTINED.set(self.quarantined_count)
        obs.FLEET_REPLICAS_DRAINING.set(self.draining_count)
        # the change test runs under the lock: _publish_membership is
        # reached from the poll thread AND from stream handlers
        # (on_stream_error), and an unguarded read-modify-write here can
        # double-fire or swallow a membership transition. The callback
        # runs OUTSIDE the lock -- it flips gRPC health (its own
        # condition), and holding the router lock across it would nest
        # foreign locks for no reason.
        with self._lock:
            changed = live != self._last_live
            if changed:
                self._last_live = live
        if changed and self.on_membership is not None:
            try:
                self.on_membership(live)
            except Exception:  # pragma: no cover - observer bug
                log.exception("fleet membership callback failed")
        return live

    @property
    def live_count(self) -> int:
        return sum(1 for r in self.replicas if r.placeable)

    @property
    def quarantined_count(self) -> int:
        """Replicas held out of the ring by an OPEN breaker (half-open
        counts as quarantined too: it is not placeable until its probe
        succeeds)."""
        return sum(
            1 for r in self.replicas
            if r.serving and r.breaker.state != CLOSED
        )

    @property
    def draining_count(self) -> int:
        """Healthy replicas held out of new-stream placement by their
        own draining flag (NOT quarantined: the breaker is closed and
        in-flight streams keep running)."""
        return sum(
            1 for r in self.replicas
            if r.serving and r.draining and r.breaker.state == CLOSED
        )

    def wait_live(self, min_live: int = 1,
                  timeout_s: float = 30.0) -> bool:
        """Block until at least ``min_live`` replicas are placeable (the
        poll thread must be running) or the timeout expires."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.live_count >= min_live:
                return True
            time.sleep(min(0.05, self.poll_s))
        return self.live_count >= min_live

    # -- placement -----------------------------------------------------------

    def pick(self, exclude: Replica | None = None) -> Replica | None:
        """Place one new stream: the least effectively-loaded placeable
        replica, ties walking the ring (idle fleets round-robin, skewed
        fleets drain toward the emptiest host). Increments the chosen
        replica's inflight; callers MUST :meth:`release` it."""
        with self._lock:
            loads = [
                r.effective_load
                if (r.placeable and r is not exclude) else float("inf")
                for r in self.replicas
            ]
            if not any(load != float("inf") for load in loads):
                return None
            idx = _least_loaded(loads, self._ring_start)
            self._ring_start = (idx + 1) % len(self.replicas)
            r = self.replicas[idx]
            r.inflight += 1
            r.placements += 1
        obs.FLEET_PLACEMENTS.labels(replica=r.endpoint).inc()
        obs.FLEET_REPLICA_STREAMS.labels(replica=r.endpoint).set(r.inflight)
        return r

    def release(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)
        obs.FLEET_REPLICA_STREAMS.labels(replica=replica.endpoint).set(
            replica.inflight)

    def count_frame(self, replica: Replica) -> None:
        """One frame relayed through ``replica``. Counted under the
        router lock: concurrent streams share a replica, and the bare
        ``replica.frames += 1`` this replaces dropped increments under
        load (the racecheck RC002 class of bug, cross-object)."""
        with self._lock:
            replica.frames += 1
        obs.FLEET_REPLICA_FRAMES.labels(replica=replica.endpoint).inc()

    def on_stream_ok(self, replica: Replica) -> None:
        """A relayed stream completed cleanly: clears the breaker's
        consecutive-failure count (stream success is as good as a health
        probe)."""
        if replica.breaker.state == CLOSED:
            replica.breaker.record_success()

    def on_stream_error(self, replica: Replica,
                        exc: BaseException | None = None) -> None:
        """A relayed stream died at the transport level: count it toward
        the replica's breaker (an open breaker quarantines the replica
        out of the ring without waiting for the next health poll)."""
        replica.breaker.record_failure(exc)
        self._publish_membership()

    def record_failover(self, *, rerouted: int = 0,
                        error_completed: int = 0) -> None:
        with self._lock:
            self.failovers_total += 1
            self.failover_frames_rerouted += rerouted
            self.failover_frames_error_completed += error_completed
        obs.FLEET_FAILOVERS.inc()
        if rerouted:
            obs.FLEET_FAILOVER_FRAMES.labels(outcome="rerouted").inc(
                rerouted)
        if error_completed:
            obs.FLEET_FAILOVER_FRAMES.labels(
                outcome="error_completed").inc(error_completed)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception:  # pragma: no cover - keep polling
                    log.exception("fleet membership poll failed")

        # one immediate tick so the front-end does not report an empty
        # fleet for a full poll period after boot
        try:
            self.poll_once()
        except Exception:  # pragma: no cover
            log.exception("initial fleet membership poll failed")
        self._thread = threading.Thread(
            target=loop, name="fleet-membership", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for r in self.replicas:
            r.close()
