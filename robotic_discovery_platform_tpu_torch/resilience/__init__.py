"""First-party resilience primitives for the serving stack.

The platform is a long-lived real-time service: a camera stream feeds a
gRPC server that depends on a remote registry, a background hot-reload
poller, and a cross-stream batch dispatcher. The training side already has
a restart story (training/supervisor.py); this package supplies the serving
side's equivalent discipline:

- :mod:`policy` -- ``RetryPolicy`` (jittered exponential backoff with an
  injectable clock/sleep/rng so tests never really sleep), ``Deadline``
  (an overall time budget shared across retries), and transient-error
  classification.
- :mod:`breaker` -- a closed/open/half-open ``CircuitBreaker`` so a
  sustained dependency outage stops burning call budget (and stops log
  spam) while the server keeps serving its current model.
- :mod:`faults` -- a named-site fault-injection registry configured via
  ``RDP_FAULTS="site:kind:count"`` so chaos tests inject connection
  errors, 5xx responses, slow calls, and compute exceptions at real call
  sites without monkeypatching.
"""

from robotic_discovery_platform_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from robotic_discovery_platform_tpu_torch.resilience.faults import (
    InjectedHTTPError,
    configure_faults,
    fault_sites,
    fired,
    inject,
)
from robotic_discovery_platform_tpu_torch.resilience.policy import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    default_retryable,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "InjectedHTTPError",
    "RetryPolicy",
    "configure_faults",
    "default_retryable",
    "fault_sites",
    "fired",
    "inject",
]
