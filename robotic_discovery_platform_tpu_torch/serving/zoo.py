"""The model zoo: serve M models from one server, the port's copy of the
JAX package's ``serving/zoo.py``.

- :class:`ModelZoo` -- the served set: M named model generations (the
  ``models/variants.py`` catalog), each with its own registry entry,
  precision tier, golden-frame parity gate, drift reference and SLO
  tracker, all sharing one batch dispatcher. The empty wire ``model``
  field resolves to the default entry, so the single-model path is a zoo
  of one, bit for bit.

- :class:`ZooPlacer` -- placement of models on chips by measured arrival
  rates (AlpaServe): models whose arrival-rate peaks anti-correlate share
  chips, so each model's burst capacity is every chip its quiet
  neighbours are not using. Per-model arrivals stream into sliding
  interval windows (:class:`RateWindow`); every ``rebalance_s`` the placer
  recomputes pairwise Pearson correlations over the aligned rate series
  and places again: each model first claims its demand-proportional share
  of chips (preferring chips whose residents' correlated load is lowest),
  then extends onto every chip whose residents all sit below the
  co-location cap. ``mode="dedicated"`` pins the static contiguous
  partition. On one card the server builds it with ``chips=1``, where
  every model's placement is ``(0,)``; its decisions over several chips
  are the JAX package's, which the CPU tests hold.

The dispatcher records each submit's arrival here and groups frames by
model, so a dispatch holds one model's frames only; the admission
estimator is keyed per (model, bucket) (``serving/admission.py``), so one
model's rides never set another's shed decisions.

Concurrency: the placer's rate windows, placement and counters are
guarded by its lock ``_lock``; the :class:`ModelZoo` is written only while
the servicer is built and read afterwards.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from robotic_discovery_platform_tpu_torch.models import variants as variants_lib
from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
)
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PLACEMENT_MODES = ("shared", "dedicated")

_PLACEMENT_ENV_VAR = "RDP_ZOO_PLACEMENT"


class UnknownModelError(KeyError):
    """A request named a model this zoo does not hold; the server answers
    that frame with an ERROR status and the stream goes on (a mistyped
    model name is a bad frame, not a dead connection)."""


def resolve_zoo_placement(configured: str) -> str:
    """The effective placement mode: ``RDP_ZOO_PLACEMENT`` when set, else
    ``ServerConfig.zoo_placement``."""
    mode = os.environ.get(_PLACEMENT_ENV_VAR) or configured
    if mode not in PLACEMENT_MODES:
        raise ValueError(
            f"unknown zoo placement {mode!r}; one of {PLACEMENT_MODES}"
        )
    return mode


@dataclass
class ZooEntry:
    """One served zoo model: everything a frame of this model touches, and
    the binding the shared dispatcher routes it through. The default
    entry reads the servicer's own generation (``analyze`` None), so the
    single-model path is untouched."""

    name: str
    variant: variants_lib.ModelVariant
    #: the single-frame analyzer of the direct path (packed rows)
    analyze: Any
    #: the served forward (``serving/server.tier_forward``)
    forward: Any
    version: int | None
    precision: str = "f32"
    #: the untransformed net kept as the parity gate's reference (None at
    #: f32)
    pristine: Any = None
    #: warm-up parity report (None at f32 and before the warm-up)
    parity: dict | None = None
    #: per-model drift monitor (monitoring/profile.DriftMonitor); the
    #: default entry's is the servicer's own ``drift``
    drift: Any = None
    #: per-model SLO tracker (observability/slo.SloTracker) or None
    slo: Any = None
    #: the batched analyzer bound on the dispatcher (``bind_model``), and
    #: again on each new dispatcher of a hot reload
    batch_analyze: Callable | None = None


class ModelZoo:
    """The served model set. Lookup is one dict read; "" resolves to the
    default entry."""

    def __init__(self, default: str = variants_lib.DEFAULT_MODEL):
        self.default = default
        self._entries: dict[str, ZooEntry] = {}

    def add(self, entry: ZooEntry) -> None:
        self._entries[entry.name] = entry

    def get(self, name: str = "") -> ZooEntry | None:
        return self._entries.get(name or self.default)

    @property
    def default_entry(self) -> ZooEntry | None:
        return self._entries.get(self.default)

    def names(self) -> tuple[str, ...]:
        return tuple(self._entries)

    def extras(self) -> tuple[ZooEntry, ...]:
        """Every entry except the default (the ones the zoo added)."""
        return tuple(e for n, e in self._entries.items()
                     if n != self.default)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: str) -> bool:
        return (name or self.default) in self._entries


class RateWindow:
    """Per-model arrival counts over fixed wall-clock intervals: a ring
    of completed-interval counts plus the accumulating current interval.
    NOT thread-safe on its own -- the placer serializes access."""

    def __init__(self, interval_s: float = 1.0, window: int = 60,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = max(1e-3, float(interval_s))
        self.counts: deque[int] = deque(maxlen=max(2, int(window)))
        self._clock = clock
        self._cur = 0
        self._cur_start = clock()

    def _advance(self, now: float) -> None:
        gap = now - self._cur_start
        if gap < self.interval_s:
            return
        steps = int(gap / self.interval_s)
        if steps >= self.counts.maxlen:
            # idle longer than the whole window: it is all zeros now
            self.counts.extend([0] * self.counts.maxlen)
            self._cur = 0
            self._cur_start = now
            return
        self.counts.append(self._cur)
        self._cur = 0
        for _ in range(steps - 1):
            self.counts.append(0)
        self._cur_start += steps * self.interval_s

    def record(self, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        self._advance(now)
        self._cur += 1

    def series(self, now: float | None = None) -> list[float]:
        """Completed-interval rates (arrivals/sec), oldest first."""
        now = self._clock() if now is None else now
        self._advance(now)
        return [c / self.interval_s for c in self.counts]

    def mean_rate(self, now: float | None = None) -> float:
        s = self.series(now)
        return sum(s) / len(s) if s else 0.0

    def peak_rate(self, now: float | None = None) -> float:
        s = self.series(now)
        return max(s) if s else 0.0


def correlation(a: list[float], b: list[float]) -> float:
    """Pearson correlation over the aligned tails of two rate series
    (0.0 when either is too short or constant -- "no evidence", which
    the placer treats as freely co-locatable)."""
    n = min(len(a), len(b))
    if n < 4:
        return 0.0
    xa, xb = a[-n:], b[-n:]
    ma = sum(xa) / n
    mb = sum(xb) / n
    va = sum((x - ma) ** 2 for x in xa)
    vb = sum((x - mb) ** 2 for x in xb)
    if va <= 0 or vb <= 0:
        return 0.0
    cov = sum((x - ma) * (y - mb) for x, y in zip(xa, xb))
    return cov / math.sqrt(va * vb)


class ZooPlacer:
    """Assign M models to N chips by measured arrival-rate correlation.

    Args:
        models: zoo model names (placement keys).
        chips: mesh width (ring indices 0..chips-1).
        mode: "shared" (correlation-driven co-location) or "dedicated"
            (static contiguous partition).
        interval_s / window: per-model rate-window geometry.
        rebalance_s: how often a recorded arrival may trigger a
            re-placement (0 = every placement is recomputed on demand
            only via :meth:`rebalance`).
        corr_cap: co-location threshold -- a model extends onto a chip
            only when every resident's correlation with it is BELOW this
            (0.25 default: unknown/uncorrelated and anti-correlated
            models share freely; clearly synchronized peaks separate).
        min_share: every model keeps at least this many chips.
        clock: injectable monotonic clock (tests never sleep).
    """

    def __init__(self, models: tuple[str, ...], chips: int, *,
                 mode: str = "shared", interval_s: float = 1.0,
                 window: int = 60, rebalance_s: float = 5.0,
                 corr_cap: float = 0.25, min_share: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if mode not in PLACEMENT_MODES:
            raise ValueError(
                f"unknown zoo placement {mode!r}; one of {PLACEMENT_MODES}"
            )
        self.models = tuple(models)
        self.chips = max(1, int(chips))
        self.mode = mode
        self.corr_cap = float(corr_cap)
        self.min_share = max(1, int(min_share))
        self.rebalance_s = float(rebalance_s)
        self._clock = clock
        self._lock = checked_lock("zoo.placer")
        self._rates = {  # guarded_by: _lock
            m: RateWindow(interval_s, window, clock) for m in self.models
        }
        self._last_rebalance = clock()  # guarded_by: _lock
        self.rebalances = 0  # guarded_by: _lock
        all_chips = tuple(range(self.chips))
        self._placement: dict[str, tuple[int, ...]] = (  # guarded_by: _lock
            self._dedicated() if mode == "dedicated"
            else {m: all_chips for m in self.models}
        )
        self._publish(self._placement)
        obs.ZOO_MODELS.set(len(self.models))

    # -- hot path ------------------------------------------------------------

    def record_arrival(self, model: str) -> None:
        """One arrival for ``model`` (the dispatcher's submit hook): bump
        its rate window and, at most every ``rebalance_s``, recompute the
        placement. O(1) amortized; the rebalance itself is O(M^2 * W)
        over tiny M."""
        now = self._clock()
        placement = None
        with self._lock:
            win = self._rates.get(model)
            if win is None:
                return
            win.record(now)
            if (self.mode == "shared" and self.rebalance_s > 0
                    and now - self._last_rebalance >= self.rebalance_s):
                self._last_rebalance = now
                placement = self._place_locked(now)
        if placement is not None:
            self._adopt(placement)

    def chips_for(self, model: str) -> tuple[int, ...]:
        """The ring indices ``model`` may dispatch to right now (every
        chip for unknown models -- the dispatcher's router still applies
        its own health gating on top)."""
        with self._lock:
            return self._placement.get(model, tuple(range(self.chips)))

    # -- placement -----------------------------------------------------------

    def _dedicated(self) -> dict[str, tuple[int, ...]]:
        """Static contiguous partition: model i gets chips
        [i*N/M, (i+1)*N/M) (at least one each)."""
        n, m = self.chips, max(1, len(self.models))
        out: dict[str, tuple[int, ...]] = {}
        for i, name in enumerate(self.models):
            lo = (i * n) // m
            hi = ((i + 1) * n) // m
            out[name] = tuple(range(lo, max(hi, lo + 1))) or (n - 1,)
        return out

    def correlations(self, now: float | None = None) -> dict[tuple, float]:
        with self._lock:
            return self._correlations_locked(
                self._clock() if now is None else now
            )

    def _correlations_locked(self, now: float) -> dict[tuple, float]:
        series = {m: w.series(now) for m, w in self._rates.items()}
        out: dict[tuple, float] = {}
        names = list(self.models)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                out[(a, b)] = correlation(series[a], series[b])
        return out

    def rebalance(self) -> dict[str, tuple[int, ...]]:
        """Force one re-placement now; returns the adopted placement."""
        with self._lock:
            if self.mode == "dedicated":
                return dict(self._placement)
            self._last_rebalance = self._clock()
            placement = self._place_locked(self._clock())
        self._adopt(placement)
        return placement

    def _place_locked(self, now: float) -> dict[str, tuple[int, ...]]:
        """The AlpaServe-flavored greedy: demand-proportional base shares
        preferring chips whose residents' correlated load is lowest
        (anti-correlation scores negative -- complements attract), then
        free extension onto chips whose residents all sit below the
        co-location cap."""
        corr = self._correlations_locked(now)

        def c(a: str, b: str) -> float:
            return corr.get((a, b), corr.get((b, a), 0.0))

        demand = {m: max(w.mean_rate(now), 1e-9)
                  for m, w in self._rates.items()}
        total = sum(demand.values())
        order = sorted(self.models, key=lambda m: -demand[m])
        residents: list[list[str]] = [[] for _ in range(self.chips)]
        placement: dict[str, tuple[int, ...]] = {}
        for m in order:
            share = max(self.min_share,
                        round(self.chips * demand[m] / total))
            share = min(share, self.chips)
            scored = sorted(
                (sum(c(m, r) * demand[r] for r in residents[i]),
                 len(residents[i]), i)
                for i in range(self.chips)
            )
            take = [i for _, _, i in scored[:share]]
            take += [
                i for _, _, i in scored[share:]
                if all(c(m, r) < self.corr_cap for r in residents[i])
            ]
            for i in take:
                residents[i].append(m)
            placement[m] = tuple(sorted(take))
        return placement

    def _adopt(self, placement: dict[str, tuple[int, ...]]) -> None:
        with self._lock:
            changed = placement != self._placement
            self._placement = placement
            if changed:
                self.rebalances += 1
                n = self.rebalances
        if changed:
            obs.ZOO_REBALANCES.inc()
            journal_lib.JOURNAL.append(
                events.ZOO_REBALANCE, rebalance=n,
                placement=";".join(
                    f"{m}:{','.join(map(str, cs))}"
                    for m, cs in sorted(placement.items())),
            )
            log.info("zoo placement #%d: %s", n,
                     {m: list(cs) for m, cs in placement.items()})
        self._publish(placement)

    def _publish(self, placement: dict[str, tuple[int, ...]]) -> None:
        now = self._clock()
        for m in self.models:
            obs.MODEL_CHIPS.labels(model=m).set(
                len(placement.get(m, ())))
            with self._lock:
                rate = self._rates[m].mean_rate(now)
            obs.MODEL_ARRIVAL_RATE.labels(model=m).set(rate)

    # -- introspection -------------------------------------------------------

    def rates(self) -> dict[str, float]:
        """Per-model mean arrival rate over the window."""
        now = self._clock()
        with self._lock:
            return {m: w.mean_rate(now) for m, w in self._rates.items()}

    def snapshot(self) -> dict:
        """The ``GET /debug/zoo`` placement block."""
        now = self._clock()
        with self._lock:
            placement = {m: list(cs) for m, cs in self._placement.items()}
            rates = {m: round(w.mean_rate(now), 3)
                     for m, w in self._rates.items()}
            peaks = {m: round(w.peak_rate(now), 3)
                     for m, w in self._rates.items()}
            corr = {f"{a}/{b}": round(v, 3)
                    for (a, b), v in self._correlations_locked(now).items()}
            rebalances = self.rebalances
        return {
            "mode": self.mode,
            "chips": self.chips,
            "placement": placement,
            "mean_rate": rates,
            "peak_rate": peaks,
            "correlation": corr,
            "rebalances": rebalances,
            "corr_cap": self.corr_cap,
        }
