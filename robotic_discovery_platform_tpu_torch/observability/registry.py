"""Zero-dependency, thread-safe metrics primitives.

Counter / Gauge / Histogram with label support, modeled on the Prometheus
client data model but stdlib-only (the image carries no prometheus_client
and nothing may be installed). One lock per metric family guards its child
map and every sample mutation; children cache their value cell so the hot
path (``child.inc()`` / ``child.observe()``) is a lock + a float add.

Naming follows Prometheus conventions: family names match
``[a-zA-Z_:][a-zA-Z0-9_:]*``, label names match ``[a-zA-Z_][a-zA-Z0-9_]*``
and may not start with ``__`` (reserved). Histograms use fixed exponential
latency buckets by default (1 ms doubling to ~16 s) -- latency is this
platform's dominant measured quantity and exponential buckets keep p99
resolution roughly constant across four decades.

Histograms answer "how is latency distributed" cheaply but their bucket
resolution floors any percentile estimate; ``Summary`` complements them
with *streaming quantiles*: per-child P^2 estimators (Jain & Chlamtac,
CACM '85 -- five markers per tracked quantile, O(1) memory and update, no
sample buffer) rendering Prometheus summary ``{quantile="0.5"}`` samples.
That is the signal SLO tracking and the future adaptive scheduler consume
directly, without a scrape-side histogram_quantile approximation.

``MetricsRegistry`` is get-or-create: asking twice for the same family
returns the same object, and asking with a *different* type or label set
raises -- two call sites silently disagreeing about a family's schema is
exactly the bug a registry exists to prevent. ``REGISTRY`` is the
process-global default every subsystem shares; tests build private
registries.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import re
import threading
import time
from typing import Callable, Iterator, NamedTuple, Sequence

from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: 1 ms doubling to ~16.4 s: fixed exponential latency buckets shared by
#: every duration histogram unless a family overrides them.
LATENCY_BUCKETS: tuple[float, ...] = tuple(0.001 * 2**k for k in range(15))


class Sample(NamedTuple):
    """One exposition line: ``name{labels} value`` (suffix appended to the
    family name -- "" for plain samples, ``_bucket``/``_sum``/``_count``
    for histogram series)."""

    suffix: str
    labels: tuple[tuple[str, str], ...]
    value: float


def _validate_labelnames(labelnames: Sequence[str]) -> tuple[str, ...]:
    names = tuple(labelnames)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate label names: {names}")
    for n in names:
        if not _LABEL_RE.match(n) or n.startswith("__"):
            raise ValueError(f"invalid label name {n!r}")
    return names


class _Metric:
    """Shared family machinery: name/help/label validation, the child map,
    and the per-family lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = _validate_labelnames(labelnames)
        # one lock per family, shared with its children (value mutations
        # and the child map agree on one owner); named per family so the
        # RDP_LOCKCHECK order graph can tell metric locks apart
        self._lock = checked_lock(f"metrics.{name}")
        self._children: dict[tuple[str, ...], object] = {}  # guarded_by: _lock
        if not self.labelnames:
            # the unlabeled singleton child, so `metric.inc()` works
            self._children[()] = self._make_child(())

    def _make_child(self, values: tuple[str, ...]):
        raise NotImplementedError

    def labels(self, **labels: str):
        """The child for one label-value combination (created on first
        use). Exactly the declared label names must be given."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        values = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child(values)
            return child

    def _require_unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                "use .labels(...) first"
            )
        return self._children[()]

    def _sorted_children(self):
        with self._lock:
            return sorted(self._children.items())

    def samples(self) -> Iterator[Sample]:
        for values, child in self._sorted_children():
            yield from child._samples(tuple(zip(self.labelnames, values)))


class _CounterChild:
    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0  # guarded_by: _lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, labels):
        yield Sample("", labels, self.value)


class Counter(_Metric):
    """Monotonically increasing count (events, frames, errors)."""

    kind = "counter"

    def _make_child(self, values):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return self._require_unlabeled().value


class _GaugeChild:
    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0  # guarded_by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, labels):
        yield Sample("", labels, self.value)


class Gauge(_Metric):
    """Point-in-time value that can go both ways (queue depth, in-flight
    streams, breaker state)."""

    kind = "gauge"

    def _make_child(self, values):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._require_unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_unlabeled().dec(amount)

    @property
    def value(self) -> float:
        return self._require_unlabeled().value


class _HistogramChild:
    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]):
        self._lock = lock
        self._buckets = buckets
        # last slot: > max bucket
        self._counts = [0] * (len(buckets) + 1)  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._count = 0  # guarded_by: _lock

    def observe(self, value: float) -> None:
        value = float(value)
        # bucket index via bisect over the sorted bounds (first bound with
        # value <= bound), not a linear scan: observe() sits on the serving
        # hot path and the default latency ladder is 15 buckets deep. NaN
        # never compares <= any bound, so it keeps landing in the overflow
        # slot (bisect would otherwise file it under the first bucket).
        if value != value:  # NaN
            i = len(self._buckets)
        else:
            i = bisect.bisect_left(self._buckets, value)
        with self._lock:
            self._sum += value
            self._count += 1
            self._counts[i] += 1

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _samples(self, labels):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative = 0
        for bound, n in zip(self._buckets, counts):
            cumulative += n
            yield Sample("_bucket", labels + (("le", _fmt_bound(bound)),),
                         float(cumulative))
        yield Sample("_bucket", labels + (("le", "+Inf"),), float(total))
        yield Sample("_sum", labels, s)
        yield Sample("_count", labels, float(total))


def _fmt_bound(bound: float) -> str:
    # integral bounds render without a trailing .0, matching the upstream
    # client's exposition (le="1" not le="1.0")
    if bound == int(bound):
        return str(int(bound))
    return repr(bound)


class Histogram(_Metric):
    """Cumulative-bucket distribution (Prometheus histogram semantics:
    ``_bucket{le=...}`` series are cumulative and end at ``+Inf``, with
    ``_sum``/``_count`` companions)."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] | None = None):
        bs = tuple(buckets) if buckets is not None else LATENCY_BUCKETS
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        if list(bs) != sorted(bs):
            raise ValueError(f"buckets must be sorted ascending: {bs}")
        if "le" in labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        self.buckets = bs
        super().__init__(name, help, labelnames)

    def _make_child(self, values):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._require_unlabeled().observe(value)

    def time(self):
        return self._require_unlabeled().time()

    @property
    def count(self) -> int:
        return self._require_unlabeled().count

    @property
    def sum(self) -> float:
        return self._require_unlabeled().sum


#: the quantiles every Summary tracks unless a family overrides them --
#: the tail ladder SLO dashboards and the adaptive scheduler read.
DEFAULT_QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99, 0.999)


class P2Quantile:
    """Streaming estimate of one quantile, P^2 algorithm (Jain & Chlamtac,
    CACM 1985): five markers whose heights approximate the q-quantile and
    its neighborhood, adjusted with a piecewise-parabolic fit on every
    observation. O(1) memory and update, no stored samples -- exactly what
    a per-label latency summary needs on the serving hot path.

    Not thread-safe on its own; the owning Summary child locks around
    ``observe``/``value`` (same policy as every other metric child)."""

    __slots__ = ("q", "_heights", "_pos", "_want", "_step", "_count")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._heights: list[float] = []  # marker heights (sorted)
        self._pos = [1, 2, 3, 4, 5]  # actual marker positions (1-based)
        self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._step = (0.0, q / 2, q, (1 + q) / 2, 1.0)
        self._count = 0

    def observe(self, x: float) -> None:
        # the JAX package's update operation for operation (the same
        # floats), its loops unrolled and its helpers inlined: every
        # served frame runs it for each quantile of five summaries
        self._count += 1
        if self._count <= 5:
            bisect.insort(self._heights, x)
            return
        h, n, want, step = self._heights, self._pos, self._want, self._step
        # the cell x falls in: every marker above it moves up one
        if x < h[0]:
            h[0] = x
            n[1] += 1
            n[2] += 1
            n[3] += 1
        elif x >= h[4]:
            h[4] = x
        elif x < h[1]:
            n[1] += 1
            n[2] += 1
            n[3] += 1
        elif x < h[2]:
            n[2] += 1
            n[3] += 1
        elif x < h[3]:
            n[3] += 1
        n[4] += 1
        want[0] += step[0]
        want[1] += step[1]
        want[2] += step[2]
        want[3] += step[3]
        want[4] += step[4]
        for i in (1, 2, 3):
            ni = n[i]
            d = want[i] - ni
            if d >= 1:
                if n[i + 1] - ni <= 1:
                    continue
                s = 1
            elif d <= -1 and n[i - 1] - ni < -1:
                s = -1
            else:
                continue
            # the piecewise-parabolic height, else the linear one
            n_lo, n_hi = n[i - 1], n[i + 1]
            h_lo, h_i, h_hi = h[i - 1], h[i], h[i + 1]
            cand = h_i + s / (n_hi - n_lo) * (
                (ni - n_lo + s) * (h_hi - h_i) / (n_hi - ni)
                + (n_hi - ni - s) * (h_i - h_lo) / (ni - n_lo)
            )
            if not h_lo < cand < h_hi:
                cand = h_i + s * (h[i + s] - h_i) / (n[i + s] - ni)
            h[i] = cand
            n[i] = ni + s

    @property
    def count(self) -> int:
        return self._count

    @property
    def value(self) -> float:
        """The current estimate; exact while <= 5 samples, NaN when empty."""
        if self._count == 0:
            return math.nan
        if self._count <= 5:
            idx = max(0, math.ceil(self.q * self._count) - 1)
            return self._heights[min(idx, self._count - 1)]
        return self._heights[2]


class _SummaryChild:
    def __init__(self, lock: threading.Lock, quantiles: tuple[float, ...]):
        self._lock = lock
        self._est = {q: P2Quantile(q) for q in quantiles}
        self._sum = 0.0  # guarded_by: _lock
        self._count = 0  # guarded_by: _lock

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for est in self._est.values():
                est.observe(value)

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._est[q].value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _samples(self, labels):
        with self._lock:
            est = [(q, e.value) for q, e in sorted(self._est.items())]
            total, s = self._count, self._sum
        if total:
            # independent P^2 estimators can invert by an epsilon at low
            # counts; exposition clamps to non-decreasing so consumers can
            # rely on p50 <= p95 <= p99 <= p99.9 structurally
            running = -math.inf
            for q, v in est:
                running = max(running, v)
                yield Sample("", labels + (("quantile", _fmt_bound(q)),),
                             running)
        yield Sample("_sum", labels, s)
        yield Sample("_count", labels, float(total))


class Summary(_Metric):
    """Streaming-quantile distribution (Prometheus summary semantics:
    per-child ``{quantile="..."}`` gauges plus ``_sum``/``_count``),
    backed by one :class:`P2Quantile` per tracked quantile. Complements a
    histogram of the same signal: the histogram aggregates across
    instances, the summary answers "what is p99 right now" exactly as the
    SLO tracker and scheduler need it, with no bucket-resolution floor."""

    kind = "summary"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 quantiles: Sequence[float] | None = None):
        qs = (tuple(quantiles) if quantiles is not None
              else DEFAULT_QUANTILES)
        if not qs:
            raise ValueError("summary needs at least one quantile")
        if list(qs) != sorted(qs) or len(set(qs)) != len(qs):
            raise ValueError(f"quantiles must be sorted and unique: {qs}")
        for q in qs:
            if not 0.0 < q < 1.0:
                raise ValueError(f"quantile must be in (0, 1), got {q}")
        if "quantile" in labelnames:
            raise ValueError("'quantile' is reserved for summary samples")
        self.quantiles = qs
        super().__init__(name, help, labelnames)

    def _make_child(self, values):
        return _SummaryChild(self._lock, self.quantiles)

    def observe(self, value: float) -> None:
        self._require_unlabeled().observe(value)

    def time(self):
        return self._require_unlabeled().time()

    def quantile(self, q: float) -> float:
        return self._require_unlabeled().quantile(q)

    @property
    def count(self) -> int:
        return self._require_unlabeled().count

    @property
    def sum(self) -> float:
        return self._require_unlabeled().sum


@contextlib.contextmanager
def time_histogram(hist):
    """Time a block into a histogram (family or labeled child)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe(time.perf_counter() - t0)


class MetricsRegistry:
    """Thread-safe name -> metric map with get-or-create semantics."""

    def __init__(self):
        self._lock = checked_lock("metrics.registry")
        self._metrics: dict[str, _Metric] = {}  # guarded_by: _lock

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], factory: Callable):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            metric = self._metrics[name] = factory()
            return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(
            Counter, name, help, labelnames,
            lambda: Counter(name, help, labelnames),
        )

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(
            Gauge, name, help, labelnames,
            lambda: Gauge(name, help, labelnames),
        )

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames,
            lambda: Histogram(name, help, labelnames, buckets),
        )

    def summary(self, name: str, help: str,
                labelnames: Sequence[str] = (),
                quantiles: Sequence[float] | None = None) -> Summary:
        return self._get_or_create(
            Summary, name, help, labelnames,
            lambda: Summary(name, help, labelnames, quantiles),
        )

    def collect(self) -> list[_Metric]:
        """Every registered family, name-sorted (deterministic exposition)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]


#: The process-global default registry every subsystem shares.
REGISTRY = MetricsRegistry()
