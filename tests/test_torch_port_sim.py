"""The port's fleet twin (``robotic_discovery_platform_tpu_torch/sim/``)
against the JAX package's ``sim/``, on the CPU: a counterpart to each
case of tests/test_sim.py.

- engine: the virtual clock protocol, tie order, re-entrant sleep, seeded
  draws;
- service-time model: the quantile fit, one draw a sample, precision
  factors, fits of one seeded LOADBENCH-shaped file equal to the JAX
  package's;
- workload: the generators draw the JAX package's schedules from the same
  seed; the trace format round-trips through ``bench_load.trace_arrivals``
  and ``tools/journal_to_trace.py``;
- metrics: ``sim.metrics.summarize_level`` equals
  ``bench_load.summarize_level`` key for key;
- the twin: the same seed and scenario give a log equal byte for byte to
  the JAX twin's, for every scripted scenario of tests/test_sim.py; the
  sweep's rows and the calibration reports equal the JAX package's;
- satellites: gossip's boot-time seed.

Deliberate divergences, each named where it shows:

- no default bench path: ``fit_loadbench`` and ``calibrate`` read only the
  file they are given (``calibrate`` without one fails), and ``sweep``
  without one takes the synthetic fit;
- a leg row that records its server's ``batch_window_ms`` is replayed at
  that window (the JAX twin models a fixed 8 ms window); rows without the
  key replay as in the JAX package.

Tolerances, fixed before measuring: none. Logs, rows and reports are
compared exactly; the quantile fit to 1e-12 relative.
"""

import json
import logging
import random
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_load  # noqa: E402
import journal_to_trace  # noqa: E402
from robotic_discovery_platform_tpu.serving import (  # noqa: E402
    fleet as jfleet,
)
from robotic_discovery_platform_tpu.sim import (  # noqa: E402
    calibrate as jcalibrate,
    cluster as jcluster,
    engine as jengine,
    metrics as jmetrics,
    model as jmodel,
    scenario as jscenario,
    sweep as jsweep,
    workload as jworkload,
)
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    fleet as tfleet,
)
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    batching as tbatching,
)
from robotic_discovery_platform_tpu_torch.sim import (  # noqa: E402
    calibrate as tcalibrate,
    cluster as tcluster,
    engine as tengine,
    metrics as tmetrics,
    model as tmodel,
    scenario as tscenario,
    sweep as tsweep,
    workload as tworkload,
)

#: package -> (engine, model, workload, cluster, scenario, sweep, calibrate)
PKGS = {
    "port": (tengine, tmodel, tworkload, tcluster, tscenario, tsweep,
             tcalibrate),
    "jax": (jengine, jmodel, jworkload, jcluster, jscenario, jsweep,
            jcalibrate),
}


@pytest.fixture(autouse=True)
def _quiet_fleet_logs():
    """The real routers log every membership change; thousands of lines
    a run say nothing here."""
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def test_virtual_clock_is_the_injectable_protocol():
    clock = tengine.VirtualClock(5.0)
    assert clock() == 5.0
    clock.t = 9.25
    assert clock() == 9.25


def test_engine_runs_events_in_time_then_schedule_order():
    eng = tengine.Engine(seed=0)
    order = []
    eng.at(2.0, lambda: order.append("b"))
    eng.at(1.0, lambda: order.append("a"))
    eng.at(2.0, lambda: order.append("c"))  # same t: scheduling order
    eng.run_until(10.0)
    assert order == ["a", "b", "c"]
    assert eng.now() == 10.0


def test_engine_sleep_is_reentrant():
    eng = tengine.Engine(seed=0)
    seen, ticks = [], []

    def waiter():
        eng.sleep(5.0)
        seen.append((eng.now(), tuple(ticks)))

    eng.every(1.0, lambda: ticks.append(eng.now()))
    eng.at(0.5, waiter)
    eng.run_until(10.0)
    assert seen[0] == (5.5, (1.0, 2.0, 3.0, 4.0, 5.0))


def test_engine_rng_is_seed_deterministic_and_the_jax_engines():
    draws = {name: [pk[0].Engine(seed=3).rng.random() for _ in range(2)]
             for name, pk in PKGS.items()}
    assert draws["port"] == draws["jax"]
    assert tengine.Engine(seed=3).rng.random() \
        != tengine.Engine(seed=4).rng.random()


# ---------------------------------------------------------------------------
# service-time model
# ---------------------------------------------------------------------------


def test_fit_quantiles_pins_p50_and_p99():
    import math

    fit = tmodel.FittedService.from_quantiles("seg", "leg", "shared", 4,
                                              30.0, 50.0, 200.0)
    assert math.exp(fit.mu) == pytest.approx(0.05, rel=1e-12)
    assert math.exp(fit.mu + 2.3263478740408408 * fit.sigma) \
        == pytest.approx(0.2, rel=1e-12)
    assert fit == tmodel.FittedService(**jmodel.FittedService.from_quantiles(
        "seg", "leg", "shared", 4, 30.0, 50.0, 200.0).__dict__)


def test_sample_consumes_exactly_one_draw():
    model = tmodel.ServiceTimeModel.synthetic()
    r1, r2 = random.Random(11), random.Random(11)
    model.sample_s(r1, "seg")
    r2.lognormvariate(0.0, 1.0)
    assert r1.random() == r2.random()


def test_precision_factors_scale_service_time():
    model = tmodel.ServiceTimeModel.synthetic()
    s_bf16 = model.sample_s(random.Random(5), "seg", precision="bf16")
    s_f32 = model.sample_s(random.Random(5), "seg", precision="f32")
    s_int8 = model.sample_s(random.Random(5), "seg", precision="int8")
    assert s_f32 == pytest.approx(2.0 * s_bf16)
    assert s_int8 == pytest.approx(0.5 * s_bf16)
    assert tmodel._precision_factors(None) == jmodel._precision_factors(None)
    jfit = jmodel.ServiceTimeModel.synthetic()
    for m in ("seg", "aux"):
        assert model.mean_s(m) == jfit.mean_s(m)
        assert model.sample_s(random.Random(8), m, precision="int8") \
            == jfit.sample_s(random.Random(8), m, precision="int8")
    assert model.goodput_rps(slots=16) == jfit.goodput_rps(slots=16)


LEGS = ("baseline-seg", "baseline-aux", "multiplexed", "dedicated")


def _bench_file(path: Path, seed: int = 0, p50_ms: float = 40.0,
                spread: float = 0.5, window_ms: float | None = None,
                fault: bool = True) -> Path:
    """A LOADBENCH-shaped file of seeded legs: each (leg, active model)
    latency sample lognormal around ``p50_ms``, summarised by
    ``bench_load.summarize_level``; plus a fault leg with errors."""
    rng = np.random.default_rng(seed)
    rows = []
    legs = list(LEGS) + (["fault"] if fault else [])
    for i, leg in enumerate(legs):
        active = ([leg.split("-", 1)[1]] if leg.startswith("baseline")
                  else ["seg", "aux"])
        models = {}
        for j, m in enumerate(("seg", "aux")):
            if m not in active:
                models[m] = bench_load.summarize_level([], 0, 0.0, 8.0,
                                                       250.0)
                continue
            lat = list(rng.lognormal(np.log(p50_ms * (1 + 0.1 * (i + j))),
                                     spread, size=160))
            errors = 40 if (leg == "fault" and m == "aux") else 0
            models[m] = bench_load.summarize_level(lat, errors, 20.0, 8.0,
                                                   250.0)
        row = bench_load.summarize_level(
            [], sum(v["errors"] for v in models.values()), 40.0, 8.0, 250.0)
        row.update(models=models, multimodel_leg=leg, chips=4,
                   placement="dedicated" if leg == "dedicated" else "shared",
                   active_models=active)
        if window_ms is not None:
            row["batch_window_ms"] = window_ms
        rows.append(row)
    path.write_text(json.dumps({
        "slo_ms": 250.0, "rows": rows,
        "multimodel": {"rate_per_model": 20.0, "period_s": 4.0,
                       "duration_s": 8.0}}))
    return path


def test_fit_loadbench_excludes_fault_leg_and_matches_jax(tmp_path):
    path = _bench_file(tmp_path / "legs.json")
    port = tmodel.ServiceTimeModel.fit_loadbench(path)
    jax_fit = jmodel.ServiceTimeModel.fit_loadbench(path, None)
    assert port.entries and all(e.leg != "fault" for e in port.entries)
    assert [e.__dict__ for e in port.entries] \
        == [e.__dict__ for e in jax_fit.entries]
    assert (port.slo_ms, port.chips, port.precision_factors) \
        == (jax_fit.slo_ms, jax_fit.chips, jax_fit.precision_factors)


def test_fit_reads_no_default_file():
    """A deliberate divergence: the JAX fit defaults to <root>/LOADBENCH.json
    and PALLASBENCH.json, figures measured on another accelerator; the
    port's names no file unless given one."""
    import inspect

    sig = inspect.signature(tmodel.ServiceTimeModel.fit_loadbench)
    assert sig.parameters["path"].default is inspect.Parameter.empty
    assert sig.parameters["pallas_path"].default is None
    assert not hasattr(tmodel, "DEFAULT_LOADBENCH")
    for path in (REPO / "robotic_discovery_platform_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert '"LOADBENCH.json"' not in text, path
        assert '"PALLASBENCH.json"' not in text, path


# ---------------------------------------------------------------------------
# workload + the shared trace format
# ---------------------------------------------------------------------------


def test_generators_draw_the_jax_schedules():
    for args in ((40.0, 40.0, 4.0, 0.0), (12.0, 20.0, 2.0, 0.5)):
        sched = tworkload.modulated_poisson(*args, random.Random(0))
        assert sched == jworkload.modulated_poisson(*args, random.Random(0))
    active = sum(1 for t, _ in tworkload.modulated_poisson(
        40.0, 40.0, 4.0, 0.0, random.Random(0)) if (t / 4.0) % 1.0 < 0.5)
    assert active / len(tworkload.modulated_poisson(
        40.0, 40.0, 4.0, 0.0, random.Random(0))) > 0.8
    assert tworkload.multimodel(("seg", "aux"), 20.0, 8.0, 4.0,
                                random.Random(7)) \
        == jworkload.multimodel(("seg", "aux"), 20.0, 8.0, 4.0,
                                random.Random(7))
    assert tworkload.diurnal(2.0, 10.0, 30.0, 60.0, random.Random(2),
                             models=("seg", "aux")) \
        == jworkload.diurnal(2.0, 10.0, 30.0, 60.0, random.Random(2),
                             models=("seg", "aux"))
    assert tworkload.poisson(30.0, 5.0, random.Random(4)) \
        == jworkload.poisson(30.0, 5.0, random.Random(4))


def test_trace_round_trip_through_both_harnesses(tmp_path):
    sched = tworkload.multimodel(("seg", "aux"), 20.0, 4.0, 2.0,
                                 random.Random(1))
    path = tmp_path / "trace.json"
    tworkload.dump_trace(str(path), sched)
    back = tworkload.from_trace(str(path))
    assert len(back) == len(sched)
    assert [m for _, m in back] == [m for _, m in sched]
    assert all(abs(a[0] - b[0]) < 1e-5 for a, b in zip(back, sched))
    assert back == jworkload.from_trace(str(path))
    arrivals = bench_load.trace_arrivals(str(path))
    assert len(arrivals) == len(sched)
    assert arrivals[-1] == pytest.approx(sched[-1][0], abs=1e-5)


def test_trace_bare_array_still_accepted(tmp_path):
    path = tmp_path / "bare.json"
    path.write_text("[100.0, 50.0, 50.0]")
    assert bench_load.trace_arrivals(str(path)) == \
        pytest.approx([0.1, 0.15, 0.2])
    sched = tworkload.from_trace(str(path), default_model="seg")
    assert [m for _, m in sched] == ["seg"] * 3


def test_trace_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError):
        tworkload.load_trace(str(bad))
    mismatch = tmp_path / "mismatch.json"
    mismatch.write_text(json.dumps({"gaps_ms": [1, 2], "models": ["a"]}))
    with pytest.raises(ValueError):
        tworkload.load_trace(str(mismatch))


def test_sim_summarize_matches_bench_exactly():
    rng = np.random.default_rng(9)
    lat = list(rng.lognormal(4.0, 0.6, size=500))
    for errors, slo in ((7, 250.0), (0, None), (3, 10.0)):
        ours = tmetrics.summarize_level(lat, errors=errors,
                                        offered_rps=33.3, wall_s=15.0,
                                        slo_ms=slo)
        assert ours == bench_load.summarize_level(
            lat, errors=errors, offered_rps=33.3, wall_s=15.0, slo_ms=slo)
        assert list(ours) == list(jmetrics.summarize_level(
            lat, errors, 33.3, 15.0, slo))
    assert tmetrics.summarize_level([], 0, 0.0, 0.0, 250.0) \
        == bench_load.summarize_level([], 0, 0.0, 0.0, 250.0)


# ---------------------------------------------------------------------------
# the twin: the JAX twin's logs, faults, calibration, sweep
# ---------------------------------------------------------------------------


def _drill_run(pkg: str, seed: int):
    engine, model, workload, cluster, scenario, _, _ = PKGS[pkg]
    eng = engine.Engine(seed=seed)
    cfg = cluster.SimConfig(n_replicas=4, n_frontends=2, autoscale=True)
    fleet = cluster.SimFleet(cfg, eng,
                             service=model.ServiceTimeModel.synthetic())
    sc = (scenario.Scenario("drill")
          .kill_replicas(5.0, 1)
          .kill_frontend(8.0, 0)
          .lease_expire(12.0, 1)
          .chip_quarantine(14.0, chips=2, duration_s=6.0)
          .brownout(16.0, scale=3.0, duration_s=6.0)
          .restart_frontend(20.0, 0)
          .restart_replicas(24.0, 1)
          .ramp(24.0, rate_hz=30.0, duration_s=4.0)
          .drift_rec(28.0))
    sched = workload.diurnal(15.0, 40.0, 15.0, 30.0, eng.rng,
                             models=("seg", "aux"))
    return fleet.run(sched, 30.0, scenario=sc)


def _kill_run(pkg: str):
    engine, model, workload, cluster, scenario, _, _ = PKGS[pkg]
    eng = engine.Engine(seed=5)
    fleet = cluster.SimFleet(cluster.SimConfig(n_replicas=3, n_frontends=1),
                             eng, service=model.ServiceTimeModel.synthetic())
    sched = workload.poisson(30.0, 10.0, eng.rng)
    return fleet.run(sched, 10.0,
                     scenario=scenario.Scenario("kill").kill_replicas(4.0, 1))


@pytest.mark.parametrize("seed", [21, 33])
def test_same_seed_same_scenario_byte_identical_log(seed):
    a, b = _drill_run("port", seed), _drill_run("port", seed)
    assert a.log_text == b.log_text
    assert len(a.log_text.splitlines()) > 50
    assert a.rows["__all__"] == b.rows["__all__"]
    j = _drill_run("jax", seed)
    assert a.log_text == j.log_text
    assert a.rows == j.rows and a.counters == j.counters


def test_different_seed_diverges():
    assert _drill_run("port", 21).log_text != _drill_run("port", 22).log_text


def test_scenario_drives_the_real_control_objects():
    res = _drill_run("port", 33)
    kinds = {line.split(" ", 2)[1] for line in res.log_text.splitlines()}
    assert "journal:fleet.lease" in kinds
    assert "journal:planner.plan" in kinds
    assert "scenario.kill_replicas" in kinds
    assert "replica.kill" in kinds
    rollout_lines = [ln for ln in res.log_text.splitlines()
                     if " scenario.rollout_cycle " in ln]
    assert rollout_lines
    assert json.loads(rollout_lines[0].split(" ", 2)[2])["outcome"] \
        == "promoted"
    assert res.rows["__all__"]["n"] > 0
    assert res.counters["replicas_live"] >= 3


def test_frame_failover_reroutes_on_replica_kill():
    res = _kill_run("port")
    assert res.counters["failovers_total"] > 0
    assert res.rows["__all__"]["errors"] < res.rows["__all__"]["n"] * 0.05
    j = _kill_run("jax")
    assert res.log_text == j.log_text and res.rows == j.rows


def test_virtual_hours_in_wall_seconds():
    cfg = tcluster.SimConfig(n_replicas=8, n_frontends=2, fleet_poll_s=10.0,
                             gossip_poll_s=10.0, controller_tick_s=5.0,
                             renew_every_s=10.0, lease_ttl_s=30.0)
    eng = tengine.Engine(seed=2)
    fleet = tcluster.SimFleet(cfg, eng,
                              service=tmodel.ServiceTimeModel.synthetic())
    sched = tworkload.diurnal(2.0, 10.0, 1800.0, 3600.0, eng.rng)
    t0 = time.monotonic()
    res = fleet.run(sched, 3600.0)
    assert time.monotonic() - t0 < 30.0
    assert res.rows["__all__"]["n"] > 1000
    assert res.counters["replicas_live"] == 8


def test_calibration_reports_equal_the_jax_gate(tmp_path):
    path = _bench_file(tmp_path / "legs.json")
    port = tcalibrate.calibrate(path, None)
    jax_report = jcalibrate.calibrate(path, None)
    assert port == jax_report
    assert port["ok"], json.dumps(port, indent=2)
    assert {r["leg"] for r in port["rows"]} == set(LEGS)
    assert port["skipped"] == [{"leg": "fault", "reason": "fault leg"}]
    assert port["tolerance"] == {"rel": 0.35, "abs_ms": 20.0,
                                 "violation": 0.05}


def test_calibration_replays_the_recorded_batch_window(tmp_path):
    """A deliberate divergence: a leg row that records its server's
    ``batch_window_ms`` replays at that window. Legs served on the direct
    path (0 ms) at a few ms of latency then pass a 1 ms floor, which the
    JAX twin's fixed 8 ms window (4 ms a frame) cannot."""
    path = _bench_file(tmp_path / "card.json", p50_ms=5.0, spread=0.3,
                       window_ms=0.0, fault=False)
    port = tcalibrate.calibrate(path, None, abs_tol_ms=1.0)
    assert port["ok"], json.dumps(port, indent=2)
    jax_report = jcalibrate.calibrate(path, None, abs_tol_ms=1.0)
    assert not jax_report["ok"]
    for row in jax_report["rows"]:
        for comp in row["models"].values():
            assert comp["p50_ms"]["sim"] > comp["p50_ms"]["measured"] + 3.0
    # with the window the JAX twin models, the port's replay is the JAX one
    eight = _bench_file(tmp_path / "eight.json", p50_ms=5.0, spread=0.3,
                        window_ms=8.0, fault=False)
    assert tcalibrate.calibrate(eight, None, abs_tol_ms=1.0) \
        == dict(jax_report, source=str(eight))


def test_calibration_refuses_empty_bench_synthetic_and_no_path(tmp_path):
    empty = tmp_path / "LOADBENCH.json"
    empty.write_text(json.dumps({"slo_ms": 250.0, "rows": []}))
    with pytest.raises(ValueError):
        tcalibrate.calibrate(empty, None)
    synthetic = tmp_path / "synthetic.json"
    rows = json.loads(_bench_file(tmp_path / "s.json").read_text())
    rows["rows"][0]["multimodel_leg"] = "synthetic"
    synthetic.write_text(json.dumps(rows))
    with pytest.raises(ValueError, match="synthetic"):
        tcalibrate.calibrate(synthetic, None)
    with pytest.raises(TypeError):
        tcalibrate.calibrate()  # no default file
    with pytest.raises(SystemExit) as exc:
        tcalibrate.main([])
    assert exc.value.code == 2


def test_calibrate_cli_writes_the_report(tmp_path, capsys):
    path = _bench_file(tmp_path / "legs.json")
    out = tmp_path / "report.json"
    assert tcalibrate.main(["--loadbench", str(path), "--out",
                            str(out)]) == 0
    assert json.loads(out.read_text()) == tcalibrate.calibrate(path, None)
    assert "calibration: OK" in capsys.readouterr().err


def test_sweep_grid_runs_with_zero_real_sleeps(monkeypatch):
    def no_sleep(_s):
        raise AssertionError("real time.sleep during a sim sweep")

    monkeypatch.setattr(time, "sleep", no_sleep)
    kw = dict(rates=(10.0, 20.0, 30.0), duration_s=8.0, period_s=4.0,
              n_replicas=3, n_frontends=1)
    report = tsweep.sweep(**kw)
    assert report["synthetic_fit"] is True and report["fit"] == "synthetic"
    assert len(report["rows"]) == 9
    for row in report["rows"]:
        for key in ("offered_rps", "n", "errors", "p50_ms", "p99_ms",
                    "violation_rate", "sweep"):
            assert key in row
        assert row["sweep"]["failure"] in (
            "none", "replica-loss", "registrar-brownout")
    jax_report = jsweep.sweep(loadbench_path=Path("/nonexistent"), **kw)
    assert report["rows"] == jax_report["rows"]


def test_sweep_rows_over_a_fitted_file_equal_the_jax_sweep(tmp_path):
    path = _bench_file(tmp_path / "legs.json")
    kw = dict(loadbench_path=path, rates=(20.0,), duration_s=8.0,
              period_s=4.0, n_replicas=2, n_frontends=2)
    port = tsweep.sweep(**kw)
    assert port["synthetic_fit"] is False and port["fit"] == str(path)
    assert port["rows"] == jsweep.sweep(**kw)["rows"]


def test_scenario_spec_round_trip():
    sc = (tscenario.Scenario("x").kill_replicas(1.0, 2)
          .brownout(2.0, scale=4.0, duration_s=3.0)
          .restart_replicas(5.0, 2))
    rebuilt = tscenario.Scenario.from_spec(sc.to_spec())
    assert rebuilt.to_spec() == sc.to_spec()
    assert sc.to_spec() == jscenario.Scenario.from_spec(
        sc.to_spec()).to_spec()
    with pytest.raises(ValueError):
        tscenario.Scenario.from_spec([{"t": 1.0, "kind": "apply"}])
    with pytest.raises(ValueError):
        tscenario.Scenario.from_spec([{"t": 1.0, "kind": "rm_rf"}])


# ---------------------------------------------------------------------------
# satellite: registrar quorum hygiene (gossip boot seed)
# ---------------------------------------------------------------------------


class _SiblingStub:
    def __init__(self, payload):
        self.payload = payload
        self.calls = 0

    def Get(self, request, timeout=None):  # noqa: N802 - gRPC surface
        self.calls += 1
        return json.dumps(self.payload).encode()


@pytest.mark.parametrize("lib", [tfleet, jfleet], ids=["port", "jax"])
def test_gossip_start_seeds_lease_table_before_first_interval(lib):
    clock = FakeClock(100.0)
    registry = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    router = lib.FleetRouter([], clock=clock, registry=registry,
                             channel_factory=lambda ep: None)
    gossip = lib.PeerGossip(["sibling:1"], registry=registry, router=router,
                            poll_s=3600.0, channel_factory=lambda ep: None)
    stub = _SiblingStub({
        "leases": {
            "replica-a:1": {"state": "active", "expires_in_s": 7.0,
                            "metrics_port": 0, "version": "3"},
            "replica-gone:1": {"state": "expired", "expires_in_s": 0.0},
        },
        "replica_loads": {},
    })
    gossip._stubs["sibling:1"] = stub
    try:
        assert registry.endpoints(lib.LEASE_ACTIVE) == []
        gossip.start()
        assert registry.state_of("replica-a:1") == lib.LEASE_ACTIVE
        assert registry.state_of("replica-gone:1") is None
        assert stub.calls == 1
        assert gossip.adopted_total == 1
    finally:
        gossip.stop()
        router.stop()


@pytest.mark.parametrize("lib", [tfleet, jfleet], ids=["port", "jax"])
def test_gossip_boot_seed_never_resurrects_expired(lib):
    clock = FakeClock(100.0)
    registry = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    router = lib.FleetRouter([], clock=clock, registry=registry,
                             channel_factory=lambda ep: None)
    registry.register("replica-a:1")
    registry.force_expire("replica-a:1")
    registry.sweep()
    gossip = lib.PeerGossip(["sibling:1"], registry=registry, router=router,
                            poll_s=3600.0, channel_factory=lambda ep: None)
    gossip._stubs["sibling:1"] = _SiblingStub({
        "leases": {"replica-a:1": {"state": "active", "expires_in_s": 9.0}},
        "replica_loads": {},
    })
    try:
        gossip.start()
        assert registry.state_of("replica-a:1") == lib.LEASE_EXPIRED
        assert gossip.adopted_total == 0
    finally:
        gossip.stop()
        router.stop()


# ---------------------------------------------------------------------------
# satellite: journal_to_trace output replays through the port's twin
# ---------------------------------------------------------------------------


def _journal_file(tmp_path, events):
    path = tmp_path / "journal.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


def test_journal_to_trace_envelope_mode(tmp_path):
    events = [{"kind": "planner.plan", "seq": i, "unix_ts": 100.0 + 5 * i,
               "attrs": {"demand_rps": str(rate)}}
              for i, rate in enumerate([40.0, 80.0, 20.0])]
    src = _journal_file(tmp_path, events)
    out = tmp_path / "trace.json"
    assert journal_to_trace.main([src, "--out", str(out), "--seed", "3",
                                  "--models", "seg,aux"]) == 0
    gaps_ms, models = tworkload.load_trace(str(out))
    assert (gaps_ms, models) == jworkload.load_trace(str(out))
    assert models and set(models) == {"seg", "aux"}
    span_s = sum(gaps_ms) / 1e3
    assert 10.0 < span_s < 16.0
    assert 20.0 < len(gaps_ms) / span_s < 80.0
    assert bench_load.trace_arrivals(str(out))
    # and the twin replays it
    eng = tengine.Engine(seed=0)
    fleet = tcluster.SimFleet(tcluster.SimConfig(n_replicas=2), eng)
    res = fleet.run(tworkload.from_trace(str(out)), span_s)
    assert res.rows["__all__"]["arrivals"] == len(gaps_ms)


def test_journal_to_trace_direct_mode(tmp_path):
    events = [{"kind": "fleet.failover", "seq": i,
               "unix_ts": 50.0 + 0.25 * i, "attrs": {"model": "seg"}}
              for i in range(8)]
    src = _journal_file(tmp_path, events)
    out = tmp_path / "direct.json"
    assert journal_to_trace.main([src, "--out", str(out),
                                  "--direct-kind", "fleet.failover"]) == 0
    gaps_ms, models = tworkload.load_trace(str(out))
    assert len(gaps_ms) == 8
    assert gaps_ms[1:] == pytest.approx([250.0] * 7)
    assert models == ["seg"] * 8


def test_journal_to_trace_no_signal_is_an_error(tmp_path):
    src = _journal_file(tmp_path, [{"kind": "fleet.lease", "seq": 0,
                                    "unix_ts": 1.0, "attrs": {}}])
    assert journal_to_trace.main([src, "--out",
                                  str(tmp_path / "never.json")]) == 2
    assert not (tmp_path / "never.json").exists()
