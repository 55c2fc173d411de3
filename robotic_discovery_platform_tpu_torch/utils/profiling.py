"""Tracing and profiling helpers (the port's counterpart of the JAX
package's ``utils/profiling.py``).

- :class:`StageTimer`: host-side stage timers that feed ``proc_time_ms``
  and the per-stage latency instruments (a copy of the JAX package's).
- :func:`capture_profile`: one on-demand ``torch.profiler`` capture of
  CPU and CUDA activity, the backend of ``GET /debug/profile`` (the JAX
  package's captures ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage. Thread-safe: a lock guards
    every mutation and read of the accumulators, so a timer shared across
    threads (the serving handler pool) cannot lose updates (the old
    version was only "per-stream" safe -- two threads racing ``+=`` on the
    same stage dropped samples).

    ``observer`` routes every closed stage into the metrics registry
    (``(stage_name, seconds)`` -- serving wires it to the
    ``rdp_stage_latency_seconds`` histogram), so per-stage timing feeds ONE
    system: the in-process summary and the exported histogram observe the
    same measurements. Called outside the lock; must not raise."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    last: dict = field(default_factory=dict)
    observer: Callable[[str, float], None] | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, dt: float) -> None:
        """Record one externally-measured sample for ``name`` (the ingest
        path measures its handler-side wait itself and feeds it here, so
        pooled decode timing rides the same accumulators and observer as
        the context-managed stages)."""
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt
        if self.observer is not None:
            self.observer(name, dt)

    def last_ms(self, *names: str) -> float:
        with self._lock:
            return 1e3 * sum(self.last.get(n, 0.0) for n in names)

    def mean_ms(self, name: str) -> float:
        with self._lock:
            return self._mean_ms_locked(name)

    def _mean_ms_locked(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return 1e3 * self.totals[name] / c if c else 0.0

    def summary(self) -> dict:
        with self._lock:
            return {
                n: {"mean_ms": self._mean_ms_locked(n),
                    "count": self.counts[n]}
                for n in self.totals
            }


# one capture at a time: the profiler is process-global state, and two
# interleaved start/stop calls corrupt both captures
_capture_lock = threading.Lock()

#: the Chrome trace a capture writes into its directory
TRACE_FILE = "trace.json"


def capture_profile(log_dir: str, seconds: float = 1.0) -> str:
    """One on-demand ``torch.profiler`` capture (CPU activity, and CUDA
    activity when a card is present) for ``seconds`` into a fresh
    timestamped subdirectory of ``log_dir``; writes the Chrome trace
    there as :data:`TRACE_FILE` and returns the subdirectory.

    This is the ``GET /debug/profile?seconds=N`` backend: a live server's
    traffic during the window lands in the trace (the card's kernels of
    every thread: CUPTI traces the whole process), and a small op runs
    inside it so the capture is never empty on an idle server. Raises
    RuntimeError when a capture is already in progress -- the caller
    surfaces that as HTTP 409 rather than corrupting the running capture.

    The profiler starts and stops only while no CUDA graph is being
    captured: both wait for the captures in progress to end and hold new
    ones back meanwhile (``ops/graphs.no_capture``), so a hot reload that
    captures its new generation's graphs during a profile is delayed by
    the start or stop, never broken by it."""
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profile capture is already in progress")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from robotic_discovery_platform_tpu_torch.ops import graphs

        target = os.path.join(
            log_dir, time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        )
        os.makedirs(target, exist_ok=True)
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        deadline = time.monotonic() + max(0.0, float(seconds))
        with graphs.no_capture():
            prof.start()
        try:
            # guarantee at least one op in the window
            x = torch.arange(64.0, device="cuda" if cuda else "cpu")
            torch.square(x).sum().item()
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                time.sleep(min(0.05, remaining))
        finally:
            with graphs.no_capture():
                prof.stop()
        prof.export_chrome_trace(os.path.join(target, TRACE_FILE))
        return target
    finally:
        _capture_lock.release()
