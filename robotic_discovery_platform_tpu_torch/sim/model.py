"""Service-time model, the one modeled piece of the twin (the port's copy
of the JAX package's ``sim/model.py``).

Everything else in the twin is the port's real object; the device ride
(submit, coalesce, dispatch, device-to-host) is replaced by a
per-(model, placement, chips) latency distribution fitted from measured
rows:

- **A LOADBENCH-shaped file** supplies the shape: each no-error leg row
  carries per-model p50/p99 under a recorded offered load, placement mode
  and chip count. A lognormal is fitted per (leg, model) by quantile
  matching (``mu = ln p50``, ``sigma = (ln p99 - ln p50) / z99``): the
  body sits on the median, the tail is pinned to the measured p99.
- **Precision** scales the draw by a per-tier factor relative to the
  measured tier (bf16 1.0, f32 2.0, int8 0.5: the byte ratio). A
  PALLASBENCH-shaped file, when one is given, adds the share of its 3x3
  conv rows that are memory-bound, for the record only.

The fit reads only the file it is given. There is no default path: the
repo's ``LOADBENCH.json`` and ``PALLASBENCH.json`` were measured on
another accelerator, so the port's twin fits legs measured on its own
card (``chip_smoke.py``'s ``sim_phase`` writes them), or
:meth:`ServiceTimeModel.synthetic`, labelled as such.

The fitted distribution is the frame's sojourn at the recorded operating
point (it already holds the measured harness's queueing at that load);
the twin's capacity layer (slots = chips x slots_per_chip) adds delay
only when offered load exceeds the calibrated point, so queueing beyond
the measurement emerges from the event queue. :mod:`.calibrate` holds
this to account: replaying each row's arrival process must reproduce its
p50/p99/violation rate within the declared tolerance.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

#: standard normal quantile at 0.99: the p50->p99 span in sigmas
_Z99 = 2.3263478740408408


@dataclass(frozen=True)
class FittedService:
    """One fitted lognormal: latency seconds for ``model`` under
    ``placement`` on ``chips`` chips, valid around ``offered_rps``."""

    model: str
    leg: str
    placement: str
    chips: int
    offered_rps: float
    p50_ms: float
    p99_ms: float
    mu: float      # ln seconds
    sigma: float

    @staticmethod
    def from_quantiles(model: str, leg: str, placement: str, chips: int,
                       offered_rps: float, p50_ms: float,
                       p99_ms: float) -> "FittedService":
        p50_ms = max(1e-3, float(p50_ms))
        p99_ms = max(p50_ms, float(p99_ms))
        mu = math.log(p50_ms / 1e3)
        sigma = max(1e-6, (math.log(p99_ms) - math.log(p50_ms)) / _Z99)
        return FittedService(model=model, leg=leg, placement=placement,
                             chips=int(chips), offered_rps=float(offered_rps),
                             p50_ms=p50_ms, p99_ms=p99_ms,
                             mu=mu, sigma=sigma)


def _precision_factors(pallas_path: os.PathLike | str | None) -> dict:
    """dtype -> service-time multiplier relative to the measured tier.

    bf16 is 1.0 by construction (the measured tier). f32 doubles the
    bytes moved and halves the tensor-core issue rate, so both the
    memory-bound and the compute-bound share of the work pay about 2x;
    int8 is the symmetric half-cost tier. When a PALLASBENCH-shaped file
    is given, the memory-bound share of its rows is recorded beside the
    factors; the factors do not change.
    """
    factors = {"bf16": 1.0, "bfloat16": 1.0, "f32": 2.0, "float32": 2.0,
               "int8": 0.5}
    if pallas_path is None:
        return factors
    try:
        data = json.loads(Path(pallas_path).read_text())
    except (OSError, ValueError):
        return factors
    rows = data.get("conv3x3") or []
    bound = [r.get("bound_by") for r in rows if r.get("bound_by")]
    if bound:
        factors["memory_bound_fraction"] = (
            bound.count("memory") / len(bound))
    return factors


class ServiceTimeModel:
    """Every fitted entry, with placement/chips-aware lookup."""

    def __init__(self, entries: Iterable[FittedService],
                 precision_factors: dict | None = None,
                 slo_ms: float = 250.0, chips: int = 4):
        self.entries = list(entries)
        if not self.entries:
            raise ValueError("service-time model needs at least one "
                             "fitted entry (is the bench file empty?)")
        self.precision_factors = dict(precision_factors or
                                      _precision_factors(None))
        self.slo_ms = float(slo_ms)
        self.chips = int(chips)
        self._by_key: dict[tuple, list[FittedService]] = {}
        for e in self.entries:
            self._by_key.setdefault((e.model, e.placement), []).append(e)
        for v in self._by_key.values():
            v.sort(key=lambda e: e.offered_rps)

    # -- construction --------------------------------------------------------

    @classmethod
    def fit_loadbench(cls, path: os.PathLike | str,
                      pallas_path: os.PathLike | str | None = None,
                      ) -> "ServiceTimeModel":
        """Fit one entry per (no-error leg, active model) of the
        LOADBENCH-shaped file at ``path`` (there is no default). The
        fault leg is excluded: its latencies are survivor-biased (every
        aux frame errored), so it would teach the model that faults are
        fast."""
        data = json.loads(Path(path).read_text())
        entries: list[FittedService] = []
        chips = 4
        for row in data.get("rows") or []:
            if row.get("errors"):
                continue
            leg = str(row.get("multimodel_leg") or row.get("leg") or "row")
            placement = str(row.get("placement") or "shared")
            chips = int(row.get("chips") or chips)
            models = row.get("models") or {"": row}
            for model, sub in models.items():
                if not sub or not sub.get("n") or sub.get("errors"):
                    continue
                if sub.get("p50_ms") is None or sub.get("p99_ms") is None:
                    continue
                entries.append(FittedService.from_quantiles(
                    model=str(model), leg=leg, placement=placement,
                    chips=chips,
                    offered_rps=float(sub.get("offered_rps") or 0.0),
                    p50_ms=sub["p50_ms"], p99_ms=sub["p99_ms"]))
        return cls(entries,
                   precision_factors=_precision_factors(pallas_path),
                   slo_ms=float(data.get("slo_ms") or 250.0), chips=chips)

    @classmethod
    def synthetic(cls, models: tuple[str, ...] = ("seg", "aux"),
                  p50_ms: float = 40.0, p99_ms: float = 160.0,
                  slo_ms: float = 250.0, chips: int = 4,
                  ) -> "ServiceTimeModel":
        """A stand-in fit where no measured file is given (unit tests,
        the sweep without a path): plausible tails, labelled synthetic
        so calibration refuses it."""
        entries = [
            FittedService.from_quantiles(
                model=m, leg="synthetic", placement="shared", chips=chips,
                offered_rps=30.0, p50_ms=p50_ms * (1.0 + 0.2 * i),
                p99_ms=p99_ms * (1.0 + 0.2 * i))
            for i, m in enumerate(models)
        ]
        return cls(entries, slo_ms=slo_ms, chips=chips)

    # -- lookup / sampling ---------------------------------------------------

    def models(self) -> tuple[str, ...]:
        return tuple(sorted({e.model for e in self.entries}))

    def lookup(self, model: str, placement: str = "shared",
               ) -> FittedService:
        """Best entry for (model, placement): exact placement match
        first, then any placement, preferring the LOWEST-load fit (least
        queueing baked in -- capacity delay is the sim's to add)."""
        for key in ((model, placement), (model, "shared"),
                    (model, "dedicated")):
            if key in self._by_key:
                return self._by_key[key][0]
        any_model = sorted(self._by_key)
        if not any_model:  # pragma: no cover - constructor forbids
            raise KeyError(model)
        return self._by_key[any_model[0]][0]

    def precision_factor(self, precision: str) -> float:
        return float(self.precision_factors.get(precision, 1.0))

    def sample_s(self, rng, model: str, *, placement: str = "shared",
                 precision: str = "bf16", scale: float = 1.0) -> float:
        """One latency draw in seconds. ``scale`` is the scenario hook
        (brownouts multiply it); draws consume exactly one rng variate
        so the schedule stays a pure function of the seed."""
        fit = self.lookup(model, placement)
        s = rng.lognormvariate(fit.mu, fit.sigma)
        return s * self.precision_factor(precision) * max(1e-6, scale)

    def mean_s(self, model: str, *, placement: str = "shared",
               precision: str = "bf16") -> float:
        """Analytic lognormal mean: the planner/capacity-side estimate."""
        fit = self.lookup(model, placement)
        return (math.exp(fit.mu + fit.sigma ** 2 / 2.0)
                * self.precision_factor(precision))

    def goodput_rps(self, *, placement: str = "shared",
                    slots: int = 8) -> float:
        """Aggregate sustainable rate across models for a replica with
        ``slots`` concurrent service slots -- the CapacityModel-shaped
        number the sim's planner wiring feeds to ``plan()``."""
        mean = max(self.mean_s(m, placement=placement)
                   for m in self.models())
        return slots / mean
