"""Prometheus text-format 0.0.4 rendering + the stdlib debug endpoint.

``render`` serializes a :class:`~.registry.MetricsRegistry` into the
Prometheus exposition format (the 0.0.4 text contract: ``# HELP`` /
``# TYPE`` headers, escaped help and label values, cumulative histogram
buckets ending at ``+Inf``, summary ``{quantile=...}`` samples).
``MetricsServer`` is a daemon-thread ``http.server`` wrapper --
deliberately not the gRPC port: scrapers and humans reach it with plain
curl, and a wedged gRPC thread pool cannot take the diagnostics surface
down with it. It serves:

- ``GET /metrics`` -- the Prometheus scrape;
- ``GET /federate`` -- the fleet-federated scrape (front-end only): every
  live replica's families under a ``replica`` label plus
  ``rdp_replica_up`` / staleness markers and the fleet roll-ups
  (observability/federation.py). Installed via
  :meth:`MetricsServer.set_federation_provider`;
- ``GET /debug/spans`` -- the flight recorder's recent + pinned dispatch
  timelines as JSON (observability/recorder.py);
- ``GET /debug/tracez`` -- the tracez-style per-span-name rollup;
- ``GET /debug/trace?id=<trace_id>`` -- one trace's stitched cross-host
  view (front-end only): the front-end's relay timelines merged with
  every replica's matching dispatch timelines into a single distributed
  tree. Installed via :meth:`MetricsServer.set_trace_provider`;
- ``GET /debug/events?since=<cursor>`` -- the structured event journal
  (observability/journal.py): breaker/quarantine transitions, controller
  and rollout actions, drift recommendations, watchdog restarts, fleet
  membership and failover decisions, in causal order with a monotonic
  resume cursor. On the fleet front-end an installed
  :meth:`MetricsServer.set_events_provider` overrides this with the
  fleet-wide aggregation (own journal merged with every member's);
- ``GET /debug/drift`` -- the online drift monitor's state as JSON
  (live vs reference histograms, per-signal PSI/JS scores, the
  recommendation ladder; monitoring/profile.py). The serving layer
  installs the provider via :meth:`MetricsServer.set_drift_provider`;
  without one the endpoint reports ``{"enabled": false}``;
- ``GET /debug/rollout`` -- the drift-triggered rollout state machine's
  state as JSON (current stage, in-flight cycle, completed-cycle
  history with per-stage timings and gate verdicts;
  serving/rollout.py). Installed via
  :meth:`MetricsServer.set_rollout_provider`, same contract as drift;
- ``GET /debug/profile?seconds=N`` -- an on-demand ``torch.profiler``
  capture of CPU and CUDA activity into ``RDP_PROFILE_DIR`` (409 when
  unset or a capture is already running; ``utils/profiling.py``), so a
  Chrome trace of the card's kernels can be pulled from a live server
  without restarting it.

The port's copy of the JAX package's module. The port's server sets the
drift, zoo and rollout providers (``serving/grpc_service.build_server``);
the fleet front-end (``serving/frontend.build_frontend``) sets the
federation, trace and events providers.

Lifecycle: ``serving.server.build_server`` starts one when
``ServerConfig.metrics_port`` / ``RDP_METRICS_PORT`` asks for it and
``VisionAnalysisService.close()`` stops it, so the endpoint lives exactly
as long as the service it describes.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from robotic_discovery_platform_tpu_torch.observability import (
    journal as journal_lib,
    recorder as recorder_lib,
)
from robotic_discovery_platform_tpu_torch.observability.registry import (
    REGISTRY,
    MetricsRegistry,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger
from robotic_discovery_platform_tpu_torch.utils.profiling import capture_profile

log = get_logger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(s: str) -> str:
    return (
        s.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")
    )


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render(registry: MetricsRegistry = REGISTRY) -> str:
    """The registry's current state as Prometheus text format 0.0.4.

    Families are name-sorted and children label-sorted, so two renders of
    the same state are byte-identical (the golden tests rely on that)."""
    lines: list[str] = []
    for metric in registry.collect():
        lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for sample in metric.samples():
            if sample.labels:
                labelstr = ",".join(
                    f'{k}="{_escape_label_value(v)}"'
                    for k, v in sample.labels
                )
                lines.append(
                    f"{metric.name}{sample.suffix}{{{labelstr}}} "
                    f"{_fmt_value(sample.value)}"
                )
            else:
                lines.append(
                    f"{metric.name}{sample.suffix} "
                    f"{_fmt_value(sample.value)}"
                )
    return "\n".join(lines) + "\n"


def _resolve_profile_dir(configured: str | None) -> str:
    """RDP_PROFILE_DIR resolver: explicit config wins, then the env knob;
    empty means on-demand profiling is off (409 from /debug/profile)."""
    return (configured or os.environ.get("RDP_PROFILE_DIR", "")).strip()


class MetricsServer:
    """``GET /metrics`` + ``/debug/*`` over stdlib ``http.server``, on a
    daemon thread.

    ``port=0`` binds an ephemeral port (tests; read it back from
    ``self.port``). ``start()`` returns self; ``stop()`` is idempotent."""

    def __init__(self, port: int, registry: MetricsRegistry = REGISTRY,
                 host: str = "0.0.0.0",
                 flight_recorder: "recorder_lib.FlightRecorder | None" = None,
                 profile_dir: str | None = None,
                 drift_provider=None,
                 journal: "journal_lib.EventJournal | None" = None):
        self._registry = registry
        self._recorder = (flight_recorder if flight_recorder is not None
                          else recorder_lib.RECORDER)
        self._journal = (journal if journal is not None
                         else journal_lib.JOURNAL)
        self._profile_dir = profile_dir
        # () -> JSON-able dict; installed after construction by the
        # serving layer (the servicer owns the DriftMonitor and is built
        # after the endpoint starts)
        self._drift_provider = drift_provider
        # same contract for the rollout state machine (serving/rollout.py)
        self._rollout_provider = None
        # and for the model zoo + placer (serving/zoo.py)
        self._zoo_provider = None
        # fleet-only surfaces (front-end process): a (trace_id) -> dict
        # stitcher behind /debug/trace and a () -> exposition-text
        # federator behind /federate (observability/federation.py)
        self._trace_provider = None
        self._federation_provider = None
        # (since) -> dict override for /debug/events: the front-end
        # installs its fleet-wide journal aggregation here; without one
        # the endpoint serves this process's own journal
        self._events_provider = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server contract)
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    self._send_text(render(outer._registry))
                elif path == "/federate":
                    provider = outer._federation_provider
                    if provider is None:
                        self._send_json({
                            "enabled": False,
                            "reason": "no fleet federator attached (the "
                                      "federated scrape lives on the "
                                      "fleet front-end's metrics port)",
                        }, status=404)
                    else:
                        self._send_text(provider())
                elif path == "/debug/spans":
                    self._send_json(outer._recorder.snapshot())
                elif path == "/debug/tracez":
                    self._send_json(outer._recorder.summary())
                elif path == "/debug/trace":
                    provider = outer._trace_provider
                    if provider is None:
                        self._send_json({
                            "enabled": False,
                            "reason": "no trace stitcher attached "
                                      "(cross-host stitching lives on "
                                      "the fleet front-end; a replica's "
                                      "own timelines are /debug/spans)",
                        }, status=404)
                        return
                    trace_id = parse_qs(query).get("id", [""])[0]
                    if not trace_id.strip():
                        self._send_json(
                            {"error": "missing ?id=<32-hex trace id>"},
                            status=400)
                        return
                    self._send_json(provider(trace_id.strip()))
                elif path == "/debug/events":
                    raw = parse_qs(query).get("since", ["0"])[0]
                    try:
                        since = int(raw)
                    except ValueError:
                        self._send_json(
                            {"error": f"bad since cursor {raw!r}"},
                            status=400)
                        return
                    provider = outer._events_provider
                    if provider is not None:
                        self._send_json(provider(since))
                    else:
                        self._send_json(outer._journal.snapshot(since))
                elif path == "/debug/drift":
                    provider = outer._drift_provider
                    if provider is None:
                        self._send_json({
                            "enabled": False,
                            "reason": "no drift monitor attached "
                                      "(ServerConfig.drift_enabled)",
                        })
                    else:
                        self._send_json(provider())
                elif path == "/debug/rollout":
                    provider = outer._rollout_provider
                    if provider is None:
                        self._send_json({
                            "enabled": False,
                            "reason": "no rollout manager attached "
                                      "(RolloutConfig.enabled / "
                                      "RDP_ROLLOUT)",
                        })
                    else:
                        self._send_json(provider())
                elif path == "/debug/zoo":
                    provider = outer._zoo_provider
                    if provider is None:
                        self._send_json({
                            "enabled": False,
                            "reason": "no model zoo attached "
                                      "(ServerConfig.zoo_models / "
                                      "RDP_ZOO_MODELS)",
                        })
                    else:
                        self._send_json(provider())
                elif path == "/debug/profile":
                    self._profile(query)
                else:
                    self.send_error(
                        404, "try /metrics, /federate, /debug/spans, "
                             "/debug/tracez, /debug/trace?id=TRACE_ID, "
                             "/debug/events?since=N, /debug/drift, "
                             "/debug/rollout, /debug/zoo, "
                             "or /debug/profile?seconds=N")

            def _send_text(self, text: str, status: int = 200):
                body = text.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, payload: dict, status: int = 200):
                body = json.dumps(payload, indent=1).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _profile(self, query: str):
                """On-demand torch.profiler capture (utils/profiling.py)
                into RDP_PROFILE_DIR; the capture runs synchronously on
                this handler thread (ThreadingHTTPServer keeps /metrics
                scrapes responsive meanwhile)."""
                profile_dir = _resolve_profile_dir(outer._profile_dir)
                if not profile_dir:
                    self._send_json(
                        {"error": "no profile directory configured; set "
                                  "RDP_PROFILE_DIR"}, status=409)
                    return
                raw = parse_qs(query).get("seconds", ["1"])[0]
                try:
                    seconds = min(max(float(raw), 0.0), 60.0)
                except ValueError:
                    self._send_json(
                        {"error": f"bad seconds value {raw!r}"}, status=400)
                    return
                try:
                    target = capture_profile(profile_dir, seconds)
                except RuntimeError as exc:  # capture already in progress
                    self._send_json({"error": str(exc)}, status=409)
                    return
                files = sum(
                    len(fs) for _, _, fs in os.walk(target)
                )
                log.info("profile capture: %.1fs -> %s (%d files)",
                         seconds, target, files)
                self._send_json({"profile_dir": target,
                                 "seconds": seconds, "files": files})

            def log_message(self, fmt, *args):
                pass  # scrapes every few seconds must not spam the log

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def set_drift_provider(self, provider) -> None:
        """Install (or clear) the ``GET /debug/drift`` payload source: a
        zero-arg callable returning a JSON-able dict."""
        self._drift_provider = provider

    def set_rollout_provider(self, provider) -> None:
        """Install (or clear) the ``GET /debug/rollout`` payload source
        (a zero-arg callable returning a JSON-able dict -- the rollout
        manager's :meth:`~robotic_discovery_platform_tpu_torch.serving.rollout.
        RolloutManager.snapshot`)."""
        self._rollout_provider = provider

    def set_zoo_provider(self, provider) -> None:
        """Install (or clear) the ``GET /debug/zoo`` payload source (a
        zero-arg callable returning a JSON-able dict -- the servicer's
        ``zoo_debug``: roster, placement, rate correlations, warm set)."""
        self._zoo_provider = provider

    def set_trace_provider(self, provider) -> None:
        """Install (or clear) the ``GET /debug/trace?id=`` stitcher: a
        callable taking one trace ID and returning a JSON-able dict (the
        fleet front-end's cross-host stitched view)."""
        self._trace_provider = provider

    def set_events_provider(self, provider) -> None:
        """Install (or clear) a ``GET /debug/events`` override: a
        callable taking the ``since`` cursor and returning a JSON-able
        dict. The fleet front-end installs its fleet-wide aggregation
        (own journal merged with every member's) here; cleared, the
        endpoint serves the process-local journal."""
        self._events_provider = provider

    def set_federation_provider(self, provider) -> None:
        """Install (or clear) the ``GET /federate`` payload source: a
        zero-arg callable returning Prometheus exposition TEXT (the
        fleet federator's re-labeled + rolled-up scrape)."""
        self._federation_provider = provider

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="metrics-exposition",
                daemon=True,
            )
            self._thread.start()
            log.info("metrics exposition on :%d/metrics", self.port)
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()


def resolve_metrics_port(cfg_port: int) -> int | None:
    """The effective exposition port: ``RDP_METRICS_PORT`` overrides the
    config value; 0 / unset means off; negative means "ephemeral port"
    (tests and smoke scripts that cannot reserve a fixed one)."""
    raw = os.environ.get("RDP_METRICS_PORT", "")
    port = int(raw) if raw.strip() else cfg_port
    if port == 0:
        return None
    return max(port, 0)


def maybe_start_metrics_server(cfg_port: int,
                               registry: MetricsRegistry = REGISTRY,
                               ) -> MetricsServer | None:
    """Start an exposition server when configuration asks for one."""
    port = resolve_metrics_port(cfg_port)
    if port is None:
        return None
    return MetricsServer(port, registry).start()
