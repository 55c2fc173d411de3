"""Failure x load sweeps: the what-if grid the live fleet cannot run (the
port's copy of the JAX package's ``sim/sweep.py``).

One cell = one fresh fleet, one seeded workload, one scenario, one
LOADBENCH-shaped row -- so a 3x3 grid answers "what does p99 and the
violation rate look like at 0.5x/1x/2x nominal load, crossed with
no-fault / correlated-replica-loss / registrar-loss-plus-brownout" in
seconds of CPU, with every cell independently reproducible from its
(seed, scenario, load) triple.

Output schema matches LOADBENCH.json rows (sim/metrics restates the
bench summarizer key-for-key) plus a ``sweep`` block naming the cell,
so downstream tooling that reads bench rows reads sweep rows unchanged.
Tune here, then confirm on the live bench: the calibration gate
(:mod:`.calibrate`) is what keeps that round trip honest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from robotic_discovery_platform_tpu_torch.sim import workload
from robotic_discovery_platform_tpu_torch.sim.cluster import (
    SimConfig,
    SimFleet,
)
from robotic_discovery_platform_tpu_torch.sim.engine import Engine
from robotic_discovery_platform_tpu_torch.sim.model import ServiceTimeModel
from robotic_discovery_platform_tpu_torch.sim.scenario import Scenario


def default_failures(duration_s: float) -> dict[str, Scenario]:
    """The stock failure axis: nothing, a correlated replica loss, and
    a registrar loss compounded by a slow-decode brownout."""
    t1 = duration_s * 0.25
    t2 = duration_s * 0.5
    return {
        "none": Scenario("none"),
        "replica-loss": (Scenario("replica-loss")
                         .kill_replicas(t1, 2)
                         .restart_replicas(t2, 2)),
        "registrar-brownout": (Scenario("registrar-brownout")
                               .kill_frontend(t1, 0)
                               .brownout(t1, scale=3.0,
                                         duration_s=t2 - t1)
                               .restart_frontend(t2, 0)),
    }


def run_cell(*, service: ServiceTimeModel, cfg: SimConfig, seed: int,
             rate_per_model: float, duration_s: float, period_s: float,
             scenario: Scenario) -> dict:
    """One sweep cell: fresh engine + fleet, seeded workload, scenario
    applied, LOADBENCH-shaped row out."""
    eng = Engine(seed=seed)
    fleet = SimFleet(cfg, eng, service=service)
    sched = workload.multimodel(list(cfg.models), rate_per_model,
                                duration_s, period_s, eng.rng)
    res = fleet.run(sched, duration_s, scenario=scenario)
    row = dict(res.rows["__all__"])
    row["models"] = {m: res.rows[m] for m in cfg.models if m in res.rows}
    row["sweep"] = {
        "failure": scenario.name,
        "rate_per_model": rate_per_model,
        "seed": seed,
        "n_replicas": cfg.n_replicas,
        "n_frontends": cfg.n_frontends,
        "placement": cfg.placement,
        "events_run": res.counters["events_run"],
        "failovers": res.counters["failovers_total"],
    }
    return row


def sweep(*, loadbench_path=None, seed: int = 0,
          rates: tuple[float, ...] = (20.0, 40.0, 80.0),
          failures: dict[str, Scenario] | None = None,
          duration_s: float = 60.0, period_s: float = 8.0,
          n_replicas: int = 4, n_frontends: int = 2,
          models: tuple[str, ...] = ("seg", "aux"),
          placement: str = "shared") -> dict:
    """The grid driver. Scenarios hold only their directive list (apply
    arms a fresh engine each cell), so one scenario serves every load
    level; each cell still gets its own engine and fleet. With no
    ``loadbench_path`` (or an unreadable one) the cells run on the
    synthetic fit, and the report says so (``synthetic_fit``)."""
    try:
        if loadbench_path is None:
            raise ValueError("no bench file named")
        service = ServiceTimeModel.fit_loadbench(loadbench_path)
    except (OSError, ValueError):
        service = ServiceTimeModel.synthetic(models=models)
    failures = failures or default_failures(duration_s)
    t0 = time.time()
    rows = []
    for rate in rates:
        for name, scenario in failures.items():
            cfg = SimConfig(n_replicas=n_replicas, n_frontends=n_frontends,
                            models=models, placement=placement)
            rows.append(run_cell(service=service, cfg=cfg, seed=seed,
                                 rate_per_model=rate, duration_s=duration_s,
                                 period_s=period_s, scenario=scenario))
    return {
        "metric": "sim_open_loop_tail_latency",
        "source": "sim",
        "fit": str(loadbench_path) if loadbench_path is not None
        else "synthetic",
        "synthetic_fit": any(e.leg == "synthetic" for e in service.entries),
        "seed": seed,
        "duration_s": duration_s,
        "grid": {"rates": list(rates), "failures": list(failures)},
        "cpu_s": round(time.time() - t0, 3),
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m robotic_discovery_platform_tpu_torch.sim.sweep",
        description="Run a failure x load sweep over the fleet sim.")
    ap.add_argument("--rates", default="20,40,80",
                    help="comma-separated per-model rates (rps)")
    ap.add_argument("--duration-s", type=float, default=60.0)
    ap.add_argument("--period-s", type=float, default=8.0)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--frontends", type=int, default=2)
    ap.add_argument("--placement", default="shared",
                    choices=("shared", "dedicated"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loadbench", default=None,
                    help="a LOADBENCH-shaped file of measured legs to fit "
                         "(default: the synthetic fit, labelled as such)")
    ap.add_argument("--scenario-spec", default="",
                    help="JSON file of scenario specs {name: spec} "
                         "replacing the stock failure axis")
    ap.add_argument("--out", default="", help="write the JSON report here")
    args = ap.parse_args(argv)
    failures = None
    if args.scenario_spec:
        specs = json.loads(Path(args.scenario_spec).read_text())
        failures = {name: Scenario.from_spec(spec)
                    for name, spec in specs.items()}
    report = sweep(
        loadbench_path=args.loadbench, seed=args.seed,
        rates=tuple(float(r) for r in args.rates.split(",") if r),
        failures=failures, duration_s=args.duration_s,
        period_s=args.period_s, n_replicas=args.replicas,
        n_frontends=args.frontends, placement=args.placement)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    print(f"sweep: {len(report['rows'])} cells in {report['cpu_s']}s CPU",
          file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI
    sys.exit(main())
