"""First-party observability: metrics registry, Prometheus exposition, and
trace propagation (the port's copy of the JAX package's JAX-free
``observability`` package, imports rewritten).

The resilience layer (retries, a circuit breaker, load shedding, a
collector watchdog) is invisible in production without it: breaker
transitions and shed frames would appear only in logs, beside the
per-frame CSV. This package is the third leg of the
analysis -> resilience -> observability triad:

- :mod:`registry` -- zero-dependency, thread-safe Counter / Gauge /
  Histogram / Summary primitives with label support, a process-global
  default registry, and a ``time_histogram`` context manager.
- :mod:`exposition` -- the Prometheus text-format 0.0.4 renderer plus a
  tiny stdlib ``http.server`` endpoint (``GET /metrics`` and the
  ``/debug/*`` pages), started and stopped with the gRPC server
  lifecycle (``ServerConfig.metrics_port`` / ``RDP_METRICS_PORT``; off by
  default).
- :mod:`trace` -- lightweight spans with W3C-style ``traceparent`` IDs
  propagated client -> server through gRPC metadata and stamped into every
  log line.
- :mod:`instruments` -- the canonical ``rdp_*`` metric families (the
  resilience package stays import-clean of this one: it exposes
  injectable observer hooks that :mod:`instruments` installs).
- :mod:`recorder` -- the flight recorder: the last N span timelines in a
  bounded ring (``GET /debug/spans`` / ``GET /debug/tracez``), error
  evidence pinned past wrap-around.
- :mod:`slo` -- latency objectives (``ServerConfig.slo_ms`` /
  ``RDP_SLO_MS``), violation counting, and error-budget burn.
- :mod:`journal` -- the structured event journal: one bounded
  append-only log of control-plane events (server readiness and drain,
  breaker transitions) with a monotonic cursor, trace-ID stamping, and
  ``GET /debug/events?since=``.
- :mod:`sketch` -- mergeable streaming histograms and quantiles.
- :mod:`federation` -- the fleet front-end's ``/federate``: every
  replica's families under a ``replica`` label, with a last-good cache.
"""

from robotic_discovery_platform_tpu_torch.observability.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Summary,
    time_histogram,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Summary",
    "time_histogram",
]
