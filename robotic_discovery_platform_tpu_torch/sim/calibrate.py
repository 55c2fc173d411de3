"""Calibration gate: the twin must reproduce the measured legs (the port's
copy of the JAX package's ``sim/calibrate.py``).

For every no-error leg of a LOADBENCH-shaped file this module
regenerates that leg's
recorded arrival process (modulated Poisson at the recorded per-model
offered rates, period and duration), replays it through the sim at the
row's chips/placement, and compares the simulated per-model
p50/p99/violation-rate against the measured row. Divergence beyond the
declared tolerance FAILS -- in CI this is the proof that "runs the real
control objects over a fitted device model" still describes reality,
and the tripwire when someone changes the device model, the engine, or
the control plane in a way that breaks the round trip.

Two honesty rules:

- Each leg is replayed against a model fitted from THAT leg's entries
  only. Legs are contention regimes (a baseline leg has the device to
  itself; a multiplexed leg shares it) and the fit encodes the sojourn
  at that regime's operating point -- replaying baseline arrivals
  through the multiplexed fit would "fail" for the right reason but
  teach the wrong lesson.
- Synthetic fits are refused. A fresh clone without bench files can run
  the sim, but it cannot claim calibration.
- The file is named, never defaulted: the port's twin claims calibration
  only against legs measured on its own card (``chip_smoke.py``'s
  ``sim_phase`` writes them; the repo's ``LOADBENCH.json`` was measured
  on another accelerator).

The fault leg is excluded: its aux stream errored wholesale, so it has
no latency marginal to reproduce (the failover machinery it exercises
is covered by the scenario tests instead).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from robotic_discovery_platform_tpu_torch.sim import workload
from robotic_discovery_platform_tpu_torch.sim.cluster import (
    SimConfig,
    SimFleet,
)
from robotic_discovery_platform_tpu_torch.sim.engine import Engine
from robotic_discovery_platform_tpu_torch.sim.model import ServiceTimeModel

#: relative tolerance on p50/p99 -- wide enough for one smoke-bench's
#: sampling noise (n in the low hundreds per leg), tight enough that a
#: regime-confused model (baseline vs multiplexed: ~1.5x p50) fails
REL_TOL = 0.35
#: absolute floor under the relative band, ms (sub-ms fits would
#: otherwise fail on scheduler jitter alone)
ABS_TOL_MS = 20.0
#: absolute tolerance on violation rate
VIOLATION_TOL = 0.05


def _within(sim: float, measured: float, rel: float, abs_floor: float,
            ) -> bool:
    return abs(sim - measured) <= max(rel * measured, abs_floor)


def calibrate_row(row: dict, model: ServiceTimeModel, *, seed: int,
                  rate_per_model: float, period_s: float,
                  duration_s: float, slo_ms: float,
                  rel_tol: float = REL_TOL, abs_tol_ms: float = ABS_TOL_MS,
                  violation_tol: float = VIOLATION_TOL) -> dict:
    """Replay one measured leg; returns the comparison record."""
    leg = str(row.get("multimodel_leg") or row.get("leg") or "row")
    placement = str(row.get("placement") or "shared")
    chips = int(row.get("chips") or model.chips)
    active = [m for m, sub in sorted((row.get("models") or {}).items())
              if sub and sub.get("n")]
    leg_model = ServiceTimeModel(
        [e for e in model.entries if e.leg == leg],
        precision_factors=model.precision_factors,
        slo_ms=slo_ms, chips=chips)
    eng = Engine(seed=seed)
    # the measured server's batch window, where the row records it: a leg
    # served on the direct path (0) waits for no window, and the JAX
    # twin's fixed 8 ms (4 ms a frame on average) would sit on every
    # replayed frame
    window = row.get("batch_window_ms")
    cfg = SimConfig(n_replicas=1, n_frontends=1, chips_per_replica=chips,
                    models=tuple(active), placement=placement,
                    slo_ms=slo_ms, deadline_ms=slo_ms,
                    window_ms=(SimConfig.window_ms if window is None
                               else float(window)))
    fleet = SimFleet(cfg, eng, service=leg_model)
    sched = workload.multimodel(active, rate_per_model, duration_s,
                                period_s, eng.rng)
    res = fleet.run(sched, duration_s)
    record = {"leg": leg, "placement": placement, "chips": chips,
              "ok": True, "models": {}}
    for m in active:
        sub = row["models"][m]
        sim_row = res.rows.get(m) or {}
        comp = {}
        for key, tol_abs in (("p50_ms", abs_tol_ms), ("p99_ms", abs_tol_ms)):
            measured = sub.get(key)
            sim_v = sim_row.get(key)
            ok = (measured is not None and sim_v is not None
                  and _within(sim_v, measured, rel_tol, tol_abs))
            comp[key] = {"measured": measured, "sim": sim_v, "ok": ok,
                         "delta_pct": (round(100.0 * (sim_v - measured)
                                             / measured, 1)
                                       if measured and sim_v is not None
                                       else None)}
            record["ok"] = record["ok"] and ok
        measured_v = float(sub.get("violation_rate") or 0.0)
        sim_v = float(sim_row.get("violation_rate") or 0.0)
        ok = abs(sim_v - measured_v) <= violation_tol
        comp["violation_rate"] = {"measured": measured_v, "sim": sim_v,
                                  "ok": ok,
                                  "delta": round(sim_v - measured_v, 4)}
        record["ok"] = record["ok"] and ok
        record["models"][m] = comp
    return record


def calibrate(loadbench_path, pallas_path=None, *, seed: int = 0,
              rel_tol: float = REL_TOL, abs_tol_ms: float = ABS_TOL_MS,
              violation_tol: float = VIOLATION_TOL) -> dict:
    """Replay every no-error leg; returns the full gate report."""
    data = json.loads(Path(loadbench_path).read_text())
    model = ServiceTimeModel.fit_loadbench(loadbench_path, pallas_path)
    if any(e.leg == "synthetic" for e in model.entries):
        raise ValueError("refusing to calibrate against a synthetic fit: "
                         "calibration needs measured LOADBENCH rows")
    mm = data.get("multimodel") or {}
    rate = float(mm.get("rate_per_model") or 40.0)
    period = float(mm.get("period_s") or 4.0)
    duration = float(mm.get("duration_s") or 8.0)
    slo_ms = float(data.get("slo_ms") or 250.0)
    report = {"source": str(loadbench_path),
              "tolerance": {"rel": rel_tol, "abs_ms": abs_tol_ms,
                            "violation": violation_tol},
              "seed": seed, "ok": True, "rows": [], "skipped": []}
    for row in data.get("rows") or []:
        leg = str(row.get("multimodel_leg") or row.get("leg") or "row")
        if row.get("errors"):
            report["skipped"].append({"leg": leg, "reason": "fault leg"})
            continue
        rec = calibrate_row(row, model, seed=seed, rate_per_model=rate,
                            period_s=period, duration_s=duration,
                            slo_ms=slo_ms, rel_tol=rel_tol,
                            abs_tol_ms=abs_tol_ms,
                            violation_tol=violation_tol)
        report["rows"].append(rec)
        report["ok"] = report["ok"] and rec["ok"]
    if not report["rows"]:
        raise ValueError(f"{loadbench_path}: no calibratable rows")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m robotic_discovery_platform_tpu_torch.sim.calibrate",
        description="Replay measured legs through the fleet sim and "
                    "gate on p50/p99/violation-rate agreement.")
    ap.add_argument("--loadbench", required=True,
                    help="the LOADBENCH-shaped file of measured legs "
                         "(no default: the twin is calibrated only "
                         "against legs its own card measured)")
    ap.add_argument("--pallasbench", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rel-tol", type=float, default=REL_TOL)
    ap.add_argument("--abs-tol-ms", type=float, default=ABS_TOL_MS)
    ap.add_argument("--violation-tol", type=float, default=VIOLATION_TOL)
    ap.add_argument("--out", default="", help="write the JSON report here")
    args = ap.parse_args(argv)
    report = calibrate(args.loadbench, args.pallasbench, seed=args.seed,
                       rel_tol=args.rel_tol, abs_tol_ms=args.abs_tol_ms,
                       violation_tol=args.violation_tol)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    print(f"calibration: {'OK' if report['ok'] else 'FAILED'} "
          f"({len(report['rows'])} legs, "
          f"{len(report['skipped'])} skipped)", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover - CLI
    sys.exit(main())
