"""Per-frame metrics CSV: the data contract the drift detector reads
(the port of the JAX package's ``serving/metrics.py``).

Columns ``timestamp,mean_curvature,max_curvature,mask_coverage_percent``.
One writer owns the file, buffers rows and flushes under a lock; rows
with a non-finite value are counted and skipped, never written.
"""

from __future__ import annotations

import atexit
import logging
import math
import threading
import time
from datetime import datetime, timezone
from pathlib import Path

log = logging.getLogger(__name__)

HEADER = "timestamp,mean_curvature,max_curvature,mask_coverage_percent"


class MetricsWriter:
    def __init__(self, path: str | Path, flush_every: int = 32,
                 flush_interval_s: float = 2.0):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.flush_every = max(1, flush_every)
        self.flush_interval_s = flush_interval_s
        self._lock = threading.Lock()
        self._buf: list[str] = []  # guarded_by: _lock
        self._last_flush = time.monotonic()
        # rows buffered between flushes must survive an exit: the tail is
        # flushed at interpreter shutdown unless close() already ran
        self._closed = False
        self.skipped_rows = 0
        atexit.register(self._flush_at_exit)
        if not self.path.exists():
            self.path.write_text(HEADER + "\n")

    def append(self, mean_curvature: float, max_curvature: float,
               mask_coverage_percent: float,
               timestamp: str | None = None) -> None:
        values = (mean_curvature, max_curvature, mask_coverage_percent)
        if not all(math.isfinite(float(v)) for v in values):
            with self._lock:
                self.skipped_rows += 1
                skipped = self.skipped_rows
            log.warning(
                "skipping non-finite metrics row (mean_curvature=%s, "
                "max_curvature=%s, coverage=%s); %d skipped so far",
                *values, skipped,
            )
            return
        ts = timestamp or datetime.now(timezone.utc).strftime(
            "%Y-%m-%d %H:%M:%S.%f")
        row = f"{ts},{mean_curvature},{max_curvature},{mask_coverage_percent}"
        with self._lock:
            self._buf.append(row)
            if (len(self._buf) >= self.flush_every
                    or time.monotonic() - self._last_flush
                    > self.flush_interval_s):
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        with open(self.path, "a") as f:
            f.write("\n".join(self._buf) + "\n")
        self._buf.clear()
        self._last_flush = time.monotonic()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_at_exit(self) -> None:
        if not self._closed:
            self.flush()

    def close(self) -> None:
        """Flush the tail and drop the exit hook. Idempotent; a late append
        still buffers and flushes."""
        self.flush()
        with self._lock:
            if self._closed:
                return
            self._closed = True
        atexit.unregister(self._flush_at_exit)
