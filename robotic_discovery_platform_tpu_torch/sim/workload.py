"""Arrival processes for the twin, sharing ``bench_load.py --trace``'s
wire format (the port's copy of the JAX package's ``sim/workload.py``;
``chip_smoke.py``'s ``sim_phase`` fires :func:`multimodel` schedules at a
server on the card).

Three sources, all yielding merged ``(offset_s, model)`` schedules:

- :func:`poisson` / :func:`modulated_poisson` -- the open-loop
  generators ``bench_load.py`` drives the live harness with, restated on
  ``random.Random`` so one engine seed determines the whole schedule
  (the bench uses numpy Generators; the twin draws from the engine's
  single ordered stream).
- :func:`diurnal` -- sinusoid-modulated Poisson by thinning: the
  multi-hour traffic shape the autoscaler is tuned against.
- :func:`from_trace` -- replay of a recorded trace. The SHARED format
  (written by ``tools/journal_to_trace.py``, read by both
  ``bench_load.py --trace`` and this module) is either a bare JSON array
  of inter-arrival gaps in milliseconds, or the object form
  ``{"gaps_ms": [...], "models": [...]}`` when the recording carries
  per-arrival model labels.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path
from typing import Sequence

Schedule = list[tuple[float, str]]


def _merge(per_model: dict[str, list[float]]) -> Schedule:
    out: Schedule = []
    for model, offsets in per_model.items():
        out.extend((t, model) for t in offsets)
    # stable, deterministic merge: time, then model name
    out.sort(key=lambda tm: (tm[0], tm[1]))
    return out


def poisson(rate_hz: float, duration_s: float, rng: random.Random,
            model: str = "seg") -> Schedule:
    """Homogeneous Poisson arrivals (bench_load.poisson_arrivals)."""
    out: list[float] = []
    if rate_hz <= 0:
        return []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_hz)
    return [(t, model) for t in out]


def modulated_poisson(mean_rate: float, duration_s: float, period_s: float,
                      phase: float, rng: random.Random, model: str = "seg",
                      peak_frac: float = 0.9) -> Schedule:
    """Square-wave-modulated Poisson (bench_load's bursty multimodel
    shape): rate_hi over the active half-period, rate_lo otherwise,
    ``peak_frac`` of traffic in the active half. Phases 0.0 / 0.5 give
    the anti-correlated AlpaServe pair."""
    hi = 2.0 * mean_rate * peak_frac
    lo = max(2.0 * mean_rate * (1.0 - peak_frac), 1e-3)
    out: list[float] = []
    t = 0.0
    while True:
        cycle = ((t / period_s) + phase) % 1.0
        rate = hi if cycle < 0.5 else lo
        t += rng.expovariate(rate)
        if t >= duration_s:
            return [(t, model) for t in out]
        out.append(t)


def multimodel(models: Sequence[str], rate_per_model: float,
               duration_s: float, period_s: float,
               rng: random.Random) -> Schedule:
    """The LOADBENCH multimodel leg shape: each model a modulated
    Poisson, phases spread so peaks anti-correlate."""
    per: dict[str, list[float]] = {}
    for i, m in enumerate(models):
        phase = i / max(1, len(models))
        per[m] = [t for t, _ in modulated_poisson(
            rate_per_model, duration_s, period_s, phase, rng, model=m)]
    return _merge(per)


def diurnal(base_rps: float, peak_rps: float, period_s: float,
            duration_s: float, rng: random.Random,
            models: Sequence[str] = ("seg",)) -> Schedule:
    """Inhomogeneous Poisson by thinning: rate(t) sweeps a raised
    cosine from ``base_rps`` up to ``peak_rps`` and back each
    ``period_s`` -- the multi-hour diurnal ramp, compressed or not."""
    peak_rps = max(peak_rps, base_rps)
    if peak_rps <= 0:
        return []
    out: Schedule = []
    t = 0.0
    i = 0
    while True:
        t += rng.expovariate(peak_rps)
        if t >= duration_s:
            return out
        rate = base_rps + (peak_rps - base_rps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / period_s))
        if rng.random() * peak_rps <= rate:
            out.append((t, models[i % len(models)]))
            i += 1


# -- the shared trace format -------------------------------------------------


def load_trace(path: str) -> tuple[list[float], list[str] | None]:
    """Parse a trace file into (gaps_ms, models|None). Accepts both the
    bare-array and object forms; raises ValueError on anything else --
    the same contract bench_load.trace_arrivals enforces."""
    data = json.loads(Path(path).read_text())
    models: list[str] | None = None
    if isinstance(data, dict):
        gaps_ms = data.get("gaps_ms")
        models = data.get("models") or None
    else:
        gaps_ms = data
    if not isinstance(gaps_ms, list) or not gaps_ms:
        raise ValueError(f"{path}: expected a non-empty JSON array of "
                         "inter-arrival milliseconds (bare or under "
                         "'gaps_ms')")
    if models is not None and len(models) != len(gaps_ms):
        raise ValueError(f"{path}: 'models' length {len(models)} != "
                         f"'gaps_ms' length {len(gaps_ms)}")
    return [float(g) for g in gaps_ms], models


def from_trace(path: str, default_model: str = "seg") -> Schedule:
    """Replay a recorded trace as a sim schedule."""
    gaps_ms, models = load_trace(path)
    out: Schedule = []
    t = 0.0
    for i, g in enumerate(gaps_ms):
        t += g / 1e3
        out.append((t, models[i] if models else default_model))
    return out


def dump_trace(path: str, schedule: Schedule) -> None:
    """Write a schedule back out in the shared object form."""
    gaps_ms: list[float] = []
    models: list[str] = []
    prev = 0.0
    for t, m in sorted(schedule, key=lambda tm: (tm[0], tm[1])):
        gaps_ms.append(round((t - prev) * 1e3, 6))
        models.append(m)
        prev = t
    Path(path).write_text(json.dumps(
        {"gaps_ms": gaps_ms, "models": models}))
