"""Fleet metrics federation: one Prometheus target for N replicas.

Every replica server exposes its own ``/metrics`` and ``/debug/spans``;
at fleet scale that is N islands a human (or a capacity planner) has to
scrape and correlate by hand. The front-end mounts a :class:`FleetFederator`
behind ``GET /federate`` on ITS metrics port:

- each live replica's exposition text is scraped (the replica advertises
  its metrics port over the stats RPC) and re-exposed with a
  ``replica="<endpoint>"`` label injected into every sample, HELP/TYPE
  headers deduplicated -- so one scrape configuration covers the whole
  fleet and per-replica series stay distinguishable;
- dead or unreachable members are marked ``rdp_replica_up 0`` and their
  LAST GOOD scrape is re-served with ``rdp_replica_scrape_age_seconds``
  as the staleness marker: a replica's death must not erase its final
  evidence from the fleet view (same reasoning as the flight recorder's
  pinned timelines), and the survivors' samples keep flowing untouched;
- fleet roll-ups the capacity planner consumes are computed from the
  stats payloads the membership poller already scrapes: aggregate
  error-budget burn (``rdp_fleet_burn{stat="mean"|"max"}``), total frames
  (``rdp_fleet_frames``), and per-model arrival rates summed across
  replicas (``rdp_fleet_model_arrival_rate{model=...}``).

A background cache thread (started with the front-end's metrics server)
keeps the last-good ``/metrics`` text AND ``/debug/spans`` payload per
replica warm, so both the federated scrape and the stitched
``/debug/trace`` can show a replica that died BETWEEN scrapes -- the
incident view must survive the incident.

The port's copy of the JAX package's module, imports rewritten: the
federated text is byte for byte the JAX front-end's for the same scrapes.
It imports neither torch nor grpc (stdlib urllib): it rides in the
front-end process, which routes bytes.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from typing import Callable, NamedTuple

from robotic_discovery_platform_tpu_torch.observability import (
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.observability.exposition import (
    render,
)
from robotic_discovery_platform_tpu_torch.observability.registry import (
    REGISTRY,
    MetricsRegistry,
)
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_HEADER_RE = re.compile(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*) ?(.*)$")


class ScrapeTarget(NamedTuple):
    """One replica as the federator sees it: the ``replica`` label value
    (its fleet endpoint), the base URL of its metrics server (None until
    the stats RPC has advertised a port), and the last stats payload the
    membership poller scraped (burn / frames / per-model rates feed the
    roll-ups without a second RPC)."""

    replica: str
    base_url: str | None
    stats: dict


class _Family:
    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str):
        self.name = name
        self.kind: str | None = None
        self.help: str | None = None
        self.samples: list[str] = []


def relabel(text: str, label: str, value: str | None,
            families: dict[str, _Family] | None = None,
            ) -> dict[str, _Family]:
    """Parse Prometheus exposition ``text`` and inject ``label="value"``
    as the FIRST label of every sample, folding the result into
    ``families`` (family order preserved; HELP/TYPE kept from the first
    source that declared them). The injected label leads so an escaped
    label value in the original tail can never confuse the splice.
    ``value=None`` parses without injecting (the front-end's own
    families carry no replica label)."""
    families = {} if families is None else families
    current: _Family | None = None
    escaped = None
    if value is not None:
        escaped = value.replace("\\", r"\\").replace("\n", r"\n").replace(
            '"', r"\"")
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        m = _HEADER_RE.match(line)
        if m is not None:
            what, name, rest = m.groups()
            current = families.setdefault(name, _Family(name))
            if what == "HELP" and current.help is None:
                current.help = rest
            elif what == "TYPE" and current.kind is None:
                current.kind = rest
            continue
        if line.startswith("#"):
            continue
        series, _, sample_value = line.rpartition(" ")
        if not series:
            continue
        brace = series.find("{")
        if brace < 0:
            name = series
            if escaped is not None:
                series = f'{series}{{{label}="{escaped}"}}'
        else:
            name = series[:brace]
            if escaped is not None:
                body = series[brace + 1:series.rindex("}")]
                sep = "," if body else ""
                series = f'{name}{{{label}="{escaped}"{sep}{body}}}'
        # samples attach to the family whose headers preceded them; a
        # suffixed sample (_bucket/_sum/_count) belongs to the family
        # its name extends
        fam = current
        if fam is None or not (name == fam.name
                               or name.startswith(fam.name + "_")):
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix):
                    base = base[:-len(suffix)]
                    break
            fam = families.setdefault(base, _Family(base))
        fam.samples.append(f"{series} {sample_value}")
    return families


def merge_exposition(families: dict[str, _Family]) -> str:
    """Serialize merged families back to exposition text (one HELP/TYPE
    header per family, all sources' samples grouped under it)."""
    lines: list[str] = []
    for fam in families.values():
        if fam.help is not None:
            lines.append(f"# HELP {fam.name} {fam.help}")
        if fam.kind is not None:
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        lines.extend(fam.samples)
    return "\n".join(lines) + "\n"


class _CacheEntry(NamedTuple):
    metrics_text: str | None
    spans: dict | None
    events: dict | None
    unix_ts: float


class FleetFederator:
    """Scrape, re-label, and roll up the fleet's observability surfaces.

    ``targets`` is a zero-arg callable returning the current
    :class:`ScrapeTarget` list (the front-end derives it from the
    router's membership + stats state), so the federator tracks
    membership without owning it. ``fetch`` is injectable for tests."""

    def __init__(self, targets: Callable[[], list[ScrapeTarget]],
                 *, registry: MetricsRegistry = REGISTRY,
                 timeout_s: float = 1.0, poll_s: float = 2.0,
                 fetch: Callable[[str, float], str] | None = None):
        self._targets = targets
        self._registry = registry
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self._fetch = fetch if fetch is not None else _http_get
        self._lock = checked_lock("federation.cache")
        self._cache: dict[str, _CacheEntry] = {}  # guarded_by: _lock
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        #: federated renders served (diagnostics / overhead bench)
        self.renders = 0

    # -- scraping ------------------------------------------------------------

    def _scrape(self, t: ScrapeTarget) -> _CacheEntry | None:
        """One live scrape of a replica's /metrics + /debug/spans; None
        when the replica is unreachable (cache untouched). Runs with NO
        lock held -- HTTP under a lock is the RC003 bug class."""
        if t.base_url is None:
            return None
        try:
            text = self._fetch(f"{t.base_url}/metrics", self.timeout_s)
            spans = json.loads(
                self._fetch(f"{t.base_url}/debug/spans", self.timeout_s))
        except Exception as exc:  # noqa: BLE001 - any transport failure
            log.debug("federation scrape of %s failed: %s", t.replica, exc)
            return None
        # the journal ride-along is separately best-effort so a member
        # without /debug/events still federates metrics + spans
        try:
            events_payload = json.loads(
                self._fetch(f"{t.base_url}/debug/events", self.timeout_s))
        except Exception as exc:  # noqa: BLE001
            log.debug("journal scrape of %s failed: %s", t.replica, exc)
            events_payload = None
        entry = _CacheEntry(text, spans, events_payload, time.time())
        with self._lock:
            self._cache[t.replica] = entry
        return entry

    def span_payloads(self) -> list[tuple[ScrapeTarget, dict | None,
                                          float, bool]]:
        """Per replica: (target, /debug/spans payload or None, age_s,
        fresh) -- live-scraped now, last-good cache for dead members.
        The trace stitcher's input."""
        out = []
        now = time.time()
        for t in self._targets():
            entry = self._scrape(t)
            fresh = entry is not None
            if entry is None:
                with self._lock:
                    entry = self._cache.get(t.replica)
            if entry is None:
                out.append((t, None, -1.0, False))
            else:
                out.append((t, entry.spans,
                            round(now - entry.unix_ts, 3), fresh))
        return out

    def journal_payloads(self) -> list[tuple[ScrapeTarget, dict | None,
                                             float, bool]]:
        """Per replica: (target, /debug/events payload or None, age_s,
        fresh) -- same live-then-last-good discipline as
        :meth:`span_payloads`. The front-end's fleet-wide
        ``/debug/events`` aggregation reads this: a SIGKILLed member's
        final journal entries survive it in the merged view."""
        out = []
        now = time.time()
        for t in self._targets():
            entry = self._scrape(t)
            fresh = entry is not None
            if entry is None:
                with self._lock:
                    entry = self._cache.get(t.replica)
            if entry is None:
                out.append((t, None, -1.0, False))
            else:
                out.append((t, entry.events,
                            round(now - entry.unix_ts, 3), fresh))
        return out

    # -- the federated scrape ------------------------------------------------

    def render(self) -> str:
        """The ``GET /federate`` payload: the front-end's own families
        (fleet gauges, roll-ups, replica_up/staleness markers) followed
        by every replica's families under a ``replica`` label."""
        targets = self._targets()
        now = time.time()
        entries: list[tuple[ScrapeTarget, _CacheEntry | None, bool]] = []
        for t in targets:
            live = self._scrape(t)
            fresh = live is not None
            entry = live
            if entry is None:
                with self._lock:
                    entry = self._cache.get(t.replica)
            entries.append((t, entry, fresh))
            obs.REPLICA_UP.labels(replica=t.replica).set(1.0 if fresh
                                                         else 0.0)
            obs.REPLICA_SCRAPE_AGE.labels(replica=t.replica).set(
                round(now - entry.unix_ts, 3) if entry is not None
                else -1.0)
            obs.REPLICA_DRAINING.labels(replica=t.replica).set(
                1.0 if (t.stats or {}).get("draining") else 0.0)
        self._rollups(targets)
        # own families first (so rdp_replica_up and the roll-ups lead),
        # then each replica's, re-labeled
        families = relabel(render(self._registry), "replica", None)
        for t, entry, _fresh in entries:
            if entry is None or entry.metrics_text is None:
                continue
            relabel(entry.metrics_text, "replica", t.replica, families)
        self.renders += 1
        return merge_exposition(families)

    def _rollups(self, targets: list[ScrapeTarget]) -> None:
        """Fleet aggregates from the stats payloads the membership
        poller already holds -- the capacity planner's demand inputs."""
        burns: list[float] = []
        frames = 0.0
        rates: dict[str, float] = {}
        for t in targets:
            stats = t.stats or {}
            try:
                burns.append(float(stats.get("burn", 0.0)))
            except (TypeError, ValueError):
                pass
            try:
                frames += float(stats.get("frames_total", 0) or 0)
            except (TypeError, ValueError):
                pass
            models = stats.get("models")
            if isinstance(models, dict):
                for name, m in models.items():
                    try:
                        rates[name] = (rates.get(name, 0.0)
                                       + float(m.get("rate", 0.0)))
                    except (TypeError, ValueError, AttributeError):
                        pass
        if burns:
            obs.FLEET_BURN.labels(stat="mean").set(
                sum(burns) / len(burns))
            obs.FLEET_BURN.labels(stat="max").set(max(burns))
        obs.FLEET_FRAMES.set(frames)
        for name, rate in rates.items():
            obs.FLEET_MODEL_ARRIVAL_RATE.labels(model=name).set(
                round(rate, 3))

    # -- background cache ----------------------------------------------------

    def start(self) -> None:
        """Keep the last-good cache warm on a daemon thread, so a replica
        that dies between /federate scrapes still has its final evidence
        (metrics AND spans) in the fleet view."""
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    for t in self._targets():
                        self._scrape(t)
                except Exception:  # pragma: no cover - keep polling
                    log.exception("federation cache refresh failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-federation", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _http_get(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")
