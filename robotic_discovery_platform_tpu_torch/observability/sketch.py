"""Streaming distribution sketches: the drift detector's data structure.

The registry's primitives answer "how often" (Counter), "how much right
now" (Gauge), and "how is latency distributed against a fixed ladder"
(Histogram/Summary). Drift detection needs a fourth shape: "what does this
signal's *distribution* look like over a window, in a form two parties can
compare" -- a live serving window scored against a reference profile
captured at training time (monitoring/profile.py). That comparison (PSI,
Jensen-Shannon) requires both sides to share a binning, so the sketch
declares its range up front: a fixed-bin online histogram over ``[lo, hi)``
with explicit underflow/overflow slots, plus exact streaming moments
(count/mean/M2, Welford) for the summary statistics the report renders.

Design rules, matching the rest of the package:

- zero dependencies (stdlib only; the image must never need a sketch lib);
- thread-safe under one per-sketch lock, same policy as the registry's
  metric children (``observe`` is a lock + an index + two adds);
- mergeable: ``merge`` folds another sketch of the same binning in
  (Chan's parallel moments), so per-thread or per-process sketches can be
  combined without a sample buffer;
- JSON round-trippable: ``snapshot()`` / ``StreamingSketch.restore()``
  serialize the full state, which is how reference profiles persist as
  registry artifacts and how ``/debug/drift`` ships live histograms.

Non-finite observations (an invalid frame's NaN curvature) are counted in
``non_finite`` but excluded from the bins and the moments -- one bad frame
must not poison the mean the way it used to poison the offline detector's
CSV column.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Sequence


class StreamingSketch:
    """Fixed-bin online histogram over ``[lo, hi)`` + streaming moments."""

    __slots__ = ("lo", "hi", "bins", "_width", "_lock", "_counts",
                 "_underflow", "_overflow", "_count", "_mean", "_m2",
                 "_non_finite")

    def __init__(self, lo: float, hi: float, bins: int = 32):
        lo, hi = float(lo), float(hi)
        if not (math.isfinite(lo) and math.isfinite(hi)) or not lo < hi:
            raise ValueError(f"need finite lo < hi, got [{lo}, {hi})")
        if bins < 1:
            raise ValueError(f"need at least one bin, got {bins}")
        self.lo, self.hi, self.bins = lo, hi, int(bins)
        self._width = (hi - lo) / bins
        self._lock = threading.Lock()
        self._counts = [0] * self.bins
        self._underflow = 0
        self._overflow = 0
        self._count = 0  # finite observations (moments cover these)
        self._mean = 0.0
        self._m2 = 0.0
        self._non_finite = 0

    # -- ingest -------------------------------------------------------------

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            with self._lock:
                self._non_finite += 1
            return
        if x < self.lo:
            i = -1
        else:
            # values at/above hi land in overflow; hi is exclusive
            i = int((x - self.lo) / self._width)
            if i >= self.bins:
                i = self.bins
        with self._lock:
            if i < 0:
                self._underflow += 1
            elif i == self.bins:
                self._overflow += 1
            else:
                self._counts[i] += 1
            self._count += 1
            delta = x - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (x - self._mean)

    def observe_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.observe(x)

    # -- read ---------------------------------------------------------------

    @property
    def count(self) -> int:
        """Finite observations (the moments' population)."""
        with self._lock:
            return self._count

    @property
    def non_finite(self) -> int:
        with self._lock:
            return self._non_finite

    @property
    def mean(self) -> float:
        with self._lock:
            return self._mean if self._count else math.nan

    @property
    def variance(self) -> float:
        """Population variance (0 for a single sample, NaN when empty)."""
        with self._lock:
            if not self._count:
                return math.nan
            return self._m2 / self._count

    @property
    def std(self) -> float:
        v = self.variance
        return math.sqrt(v) if v == v else math.nan

    def counts(self) -> list[int]:
        """``[underflow, bin_0 .. bin_{n-1}, overflow]`` -- the comparison
        vector PSI/JS scoring consumes (monitoring/profile.py)."""
        with self._lock:
            return [self._underflow, *self._counts, self._overflow]

    def probabilities(self) -> list[float]:
        """``counts()`` normalized to sum 1 (uniform when empty, so an
        empty live window scores 0 divergence against nothing)."""
        c = self.counts()
        total = sum(c)
        if total == 0:
            return [1.0 / len(c)] * len(c)
        return [n / total for n in c]

    def bin_edges(self) -> list[float]:
        return [self.lo + i * self._width for i in range(self.bins + 1)]

    def compatible(self, other: "StreamingSketch") -> bool:
        """Same binning -- the precondition for merge and for divergence
        scoring."""
        return (self.lo == other.lo and self.hi == other.hi
                and self.bins == other.bins)

    # -- combine / persist --------------------------------------------------

    def merge(self, other: "StreamingSketch") -> "StreamingSketch":
        """Fold ``other`` into this sketch in place (exact counts; moments
        via Chan's parallel update). Returns self."""
        if not self.compatible(other):
            raise ValueError(
                f"cannot merge sketch [{other.lo}, {other.hi})x{other.bins} "
                f"into [{self.lo}, {self.hi})x{self.bins}"
            )
        # snapshot other under ITS lock, then apply under ours: two locks
        # are never held at once, so cross-merging threads cannot deadlock
        o = other.snapshot()
        with self._lock:
            self._underflow += o["underflow"]
            self._overflow += o["overflow"]
            for i, n in enumerate(o["counts"]):
                self._counts[i] += n
            self._non_finite += o["non_finite"]
            n_a, n_b = self._count, o["count"]
            if n_b:
                delta = o["mean"] - self._mean
                n = n_a + n_b
                self._mean += delta * n_b / n
                self._m2 += o["m2"] + delta * delta * n_a * n_b / n
                self._count = n
        return self

    def snapshot(self) -> dict:
        """JSON-ready full state; ``restore`` inverts it exactly."""
        with self._lock:
            return {
                "lo": self.lo,
                "hi": self.hi,
                "bins": self.bins,
                "counts": list(self._counts),
                "underflow": self._underflow,
                "overflow": self._overflow,
                "count": self._count,
                "mean": self._mean,
                "m2": self._m2,
                "non_finite": self._non_finite,
            }

    @classmethod
    def restore(cls, state: dict) -> "StreamingSketch":
        s = cls(state["lo"], state["hi"], state["bins"])
        counts = list(state["counts"])
        if len(counts) != s.bins:
            raise ValueError(
                f"snapshot carries {len(counts)} bins, declared {s.bins}"
            )
        s._counts = [int(n) for n in counts]
        s._underflow = int(state["underflow"])
        s._overflow = int(state["overflow"])
        s._count = int(state["count"])
        s._mean = float(state["mean"])
        s._m2 = float(state["m2"])
        s._non_finite = int(state.get("non_finite", 0))
        return s

    @classmethod
    def from_values(cls, lo: float, hi: float, bins: int,
                    values: Sequence[float]) -> "StreamingSketch":
        s = cls(lo, hi, bins)
        s.observe_many(values)
        return s

    def __repr__(self) -> str:  # debug aid only
        return (f"StreamingSketch([{self.lo}, {self.hi})x{self.bins}, "
                f"n={self.count}, mean={self.mean:.4g})")
