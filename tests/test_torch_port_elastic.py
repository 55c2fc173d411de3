"""The port's elastic membership and autoscaler (the lease machine, the
lease RPCs and client, peer gossip, the capacity planner and the
drain-driven autoscaler of serving/fleet.py and serving/planner.py)
against the JAX package's, on the CPU.

Every scenario of the JAX package's tests/test_elastic.py runs on both
packages' objects with one fake clock each: the same lease states and
transitions, journal events, router membership, plans and autoscaler
decisions. The lease RPCs cross the packages both ways (a port
LeaseClient against a JAX registrar and the reverse). One test boots a
real front-end and a real replica as subprocesses on the CPU: the
replica registers its lease with the front-end, serves through it, and
leaves on SIGTERM.

The one deliberate difference: ``CapacityModel.resolve`` never reads
``<root>/LOADBENCH.json`` or ``<root>/PALLASBENCH.json`` (TPU figures in
this repository); it fits only the configured file.

Tolerances, fixed before measuring: none. States, events, plans and
decisions are compared exactly.
"""

import json
import logging
import time
from concurrent import futures
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.observability import (
    journal as jjournal,
)
from robotic_discovery_platform_tpu.serving import fleet as jfleet
from robotic_discovery_platform_tpu.serving import frontend as jfrontend
from robotic_discovery_platform_tpu.serving import health as jhealth
from robotic_discovery_platform_tpu.serving import planner as jplanner
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.observability import (
    journal as tjournal,
)
from robotic_discovery_platform_tpu_torch.serving import client
from robotic_discovery_platform_tpu_torch.serving import fleet as tfleet
from robotic_discovery_platform_tpu_torch.serving import frontend as tfrontend
from robotic_discovery_platform_tpu_torch.serving import health as thealth
from robotic_discovery_platform_tpu_torch.serving import planner as tplanner
from robotic_discovery_platform_tpu_torch.serving import replica
from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc
from robotic_discovery_platform_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
#: package -> (fleet, planner, health, journal, config, frontend)
PKGS = {
    "port": (tfleet, tplanner, thealth, tjournal, config, tfrontend),
    "jax": (jfleet, jplanner, jhealth, jjournal, jconfig, jfrontend),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _events_since(journal_lib, cursor) -> list:
    """(kind, attrs) of each journal event after ``cursor``."""
    return [(e["kind"], e.get("attrs", {}))
            for e in journal_lib.JOURNAL.snapshot(cursor)["events"]]


def _both(script):
    """Run ``script(pkg)`` on the port and on the JAX package, with each
    package's lease observer recording edges and its journal read from
    the script's start; returns {pkg: (result, edges, events)}."""
    out = {}
    for pkg, (fleet_lib, *_rest) in PKGS.items():
        journal_lib = PKGS[pkg][3]
        edges = []
        restore = fleet_lib._lease_observer
        fleet_lib.set_lease_observer(
            lambda ep, frm, to, edges=edges: edges.append((ep, frm, to)))
        cursor = journal_lib.JOURNAL.snapshot()["next_cursor"]
        try:
            result = script(pkg)
        finally:
            fleet_lib.set_lease_observer(restore)
        out[pkg] = (result, edges, _events_since(journal_lib, cursor))
    return out


# -- the lease machine ---------------------------------------------------------


def _lifecycle(pkg):
    lib = PKGS[pkg][0]
    clock = _FakeClock()
    reg = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    trail = [reg.register("r:1"), reg.state_of("r:1")]
    clock.t = 10.0
    trail += [reg.sweep(), reg.state_of("r:1")]
    reg.register("r:1")
    trail.append(reg.state_of("r:1"))
    return trail


def _renew_race(pkg):
    lib = PKGS[pkg][0]
    clock = _FakeClock()
    reg = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    reg.register("r:1")
    clock.t = 5.0
    trail = [reg.renew("r:1"), reg.get("r:1").expires_at]
    clock.t = 15.0
    trail += [reg.renew("r:1"), reg.state_of("r:1"), reg.sweep(),
              reg.renew("r:1"), reg.state_of("r:1")]
    return trail


def _leave_vs_expiry(pkg):
    lib = PKGS[pkg][0]
    clock = _FakeClock()
    reg = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    reg.register("graceful:1")
    reg.register("killed:1")
    reg.leave("graceful:1")
    clock.t = 10.0
    trail = [reg.sweep(), reg.state_of("graceful:1"),
             reg.state_of("killed:1")]
    reg.leave("killed:1")
    trail.append(reg.state_of("killed:1"))
    return trail


def _double_register(pkg):
    lib = PKGS[pkg][0]
    clock = _FakeClock()
    reg = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    reg.register("r:1")
    clock.t = 4.0
    reg.register("r:1", metrics_port=9100, version="3")
    lease = reg.get("r:1")
    return [lease.expires_at, lease.metrics_port, lease.version,
            reg.snapshot()]


def _adopt(pkg):
    lib = PKGS[pkg][0]
    clock = _FakeClock()
    reg = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
    reg.register("dead:1")
    clock.t = 10.0
    reg.sweep()
    trail = [reg.adopt("dead:1", expires_in_s=8.0), reg.state_of("dead:1"),
             reg.adopt("new:1", expires_in_s=99.0, metrics_port=9101),
             reg.state_of("new:1"), reg.get("new:1").expires_at]
    clock.t = 30.0
    trail += [reg.prunable(5.0), reg.endpoints(), reg.snapshot()]
    reg.force_expire("new:1")
    trail += [reg.sweep(), reg.endpoints(lib.LEASE_EXPIRED)]
    return trail


@pytest.mark.parametrize("script", [_lifecycle, _renew_race,
                                    _leave_vs_expiry, _double_register,
                                    _adopt])
def test_lease_machine_matches_jax(script):
    """The same states, transitions (the observer's edges) and journal
    events in both packages."""
    runs = _both(script)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0]  # the script returned its trail


def test_lease_states_and_paths_are_the_jax_ones():
    assert tfleet.LEASE_STATES == jfleet.LEASE_STATES
    assert tfleet.STATS_SERVICE == jfleet.STATS_SERVICE
    for path in ("_STATS_PATH", "_DRAIN_PATH", "_REGISTER_PATH",
                 "_RENEW_PATH", "_LEAVE_PATH"):
        assert getattr(tfleet, path) == getattr(jfleet, path)


# -- router x lease edges --------------------------------------------------------


@pytest.fixture()
def health_servers():
    out = {}
    for pkg, mods in PKGS.items():
        health_lib = mods[2]
        health = health_lib.HealthServicer()
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        health_lib.add_HealthServicer_to_server(health, server)
        port = server.add_insecure_port("localhost:0")
        server.start()
        health.set("", health_lib.SERVING)
        out[pkg] = (f"localhost:{port}", server)
    yield out
    for _, server in out.values():
        server.stop(grace=None)


def _elastic_router(lib, endpoint, clock, ttl_s=10.0):
    registry = lib.LeaseRegistry(ttl_s=ttl_s, clock=clock)
    router = lib.FleetRouter([], breaker_failures=2, breaker_reset_s=5.0,
                             clock=clock, registry=registry)
    registry.register(endpoint)
    return registry, router


def test_lease_edges_through_the_router_match_jax(health_servers):
    """Expiry quarantines (never drops) a member, a re-register readmits
    it through the half-open probe, Leave drains it with health up, and a
    long-dead idle lease is pruned: the same trail in both packages."""
    def script(pkg):
        lib = PKGS[pkg][0]
        endpoint = health_servers[pkg][0]
        clock = _FakeClock()
        registry, router = _elastic_router(lib, endpoint, clock)
        trail = []
        try:
            trail.append(router.poll_once())
            r = router.replicas[0]
            clock.t = 10.0
            trail += [router.poll_once(), r.placeable]
            router.poll_once()
            trail += [r.breaker.state, len(router.replicas)]
            registry.register(endpoint)
            trail.append(router.poll_once())
            clock.t += 5.1
            trail += [router.poll_once(), r.placeable]
            registry.leave(endpoint)
            router.poll_once()
            trail += [r.serving, r.draining, r.placeable]
            clock.t += router.PRUNE_TTLS * registry.ttl_s + 1.0
            router.poll_once()
            trail += [len(router.replicas), registry.state_of(endpoint)]
        finally:
            router.stop()
        # the endpoint differs per package: name it by role
        return [t if not isinstance(t, str) else t.replace(endpoint, "ep")
                for t in trail]

    runs = _both(script)

    def neutral(run):
        result, edges, events = run
        ep = {health_servers[p][0] for p in PKGS}
        clean = json.loads(json.dumps([result, edges, events]))
        text = json.dumps(clean)
        for e in ep:
            text = text.replace(e, "ep")
        return json.loads(text)

    assert neutral(runs["port"]) == neutral(runs["jax"])
    assert runs["port"][0][:3] == [1, 0, False]


# -- the lease RPCs, both ways -----------------------------------------------------


@pytest.fixture()
def lease_servers():
    out = {}
    for pkg, mods in PKGS.items():
        registry = mods[0].LeaseRegistry(ttl_s=10.0)
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        mods[0].add_fleet_rpcs_to_server(server, registry=registry)
        port = server.add_insecure_port("localhost:0")
        server.start()
        out[pkg] = (registry, f"localhost:{port}", server)
    yield out
    for _, _, server in out.values():
        server.stop(grace=None)


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_lease_client_wire_both_ways(lease_servers, client_pkg, server_pkg):
    """A port LeaseClient registers, renews and leaves with a JAX
    registrar and a JAX LeaseClient with a port one; a refused renew
    falls back to Register."""
    lib = PKGS[client_pkg][0]
    registry, registrar, _ = lease_servers[server_pkg]
    server_lib = PKGS[server_pkg][0]
    lease_client = lib.LeaseClient(
        [registrar], endpoint="replica-x:50051", metrics_port=9100,
        version="5", ttl_s=10.0)
    fallback = lib.LeaseClient([registrar], endpoint="replica-y:50052",
                               ttl_s=10.0)
    try:
        assert lease_client.register() == 1
        lease = registry.get("replica-x:50051")
        assert (lease.metrics_port, lease.version) == (9100, "5")
        assert lease_client.renew_once() == 1
        assert registry.get("replica-x:50051").renewals == 1
        lease_client.leave()
        assert registry.state_of("replica-x:50051") == server_lib.LEASE_LEFT
        assert fallback.renew_once() == 0
        assert fallback.registrations == 1
        assert registry.state_of("replica-y:50052") == server_lib.LEASE_ACTIVE
    finally:
        lease_client.stop()
        fallback.stop()


def test_lease_rpc_bytes_match_jax(lease_servers):
    """The Register, Renew and Leave answers are byte for byte the JAX
    registrar's, and an empty endpoint is refused INVALID_ARGUMENT by
    both."""
    answers = {}
    for pkg, (_, registrar, _) in lease_servers.items():
        channel = grpc.insecure_channel(registrar)
        try:
            stub = tfleet.FleetLeaseStub(channel)
            body = json.dumps({"endpoint": "r:1", "metrics_port": 1,
                               "version": "2"}).encode()
            answers[pkg] = [stub.Register(body, timeout=5),
                            stub.Renew(body, timeout=5),
                            stub.Leave(body, timeout=5)]
            with pytest.raises(grpc.RpcError) as err:
                stub.Register(b"{}", timeout=5)
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            with pytest.raises(grpc.RpcError) as err:
                stub.Renew(body, timeout=5)  # left: no active lease
            assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        finally:
            channel.close()
    assert answers["port"] == answers["jax"]


def test_gossip_adopts_leases_and_folds_loads_as_jax():
    sibling_payload = {
        "role": "frontend",
        "leases": {
            "replica-g:1": {"state": "active", "expires_in_s": 7.0,
                            "metrics_port": 9100, "version": "2"},
            "replica-dead:1": {"state": "expired", "expires_in_s": 0.0},
        },
        "replica_loads": {"static:1": 3},
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    jfleet.add_fleet_rpcs_to_server(
        server, stats_provider=lambda: sibling_payload)
    port = server.add_insecure_port("localhost:0")
    server.start()

    def script(pkg):
        lib = PKGS[pkg][0]
        clock = _FakeClock()
        registry = lib.LeaseRegistry(ttl_s=10.0, clock=clock)
        router = lib.FleetRouter(["static:1"], clock=clock,
                                 registry=registry,
                                 channel_factory=lambda ep: None)
        gossip = lib.PeerGossip([f"localhost:{port}"], registry=registry,
                                router=router)
        try:
            return [gossip.poll_once(), registry.state_of("replica-g:1"),
                    gossip.adopted_total, registry.state_of("replica-dead:1"),
                    router.replicas[0].external,
                    router.replicas[0].effective_load, registry.snapshot()]
        finally:
            gossip.stop()
            router.stop()

    try:
        runs = _both(script)
    finally:
        server.stop(grace=None)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][:5] == [1, "active", 1, None, 3]


# -- the planner -------------------------------------------------------------------


def _write_loadbench(path, rows):
    path.write_text(json.dumps({"slo_ms": 50.0, "rows": rows}))
    return str(path)


def test_capacity_fit_matches_jax(tmp_path):
    bench = _write_loadbench(tmp_path / "bench.json", [
        {"goodput_rps": 40.0, "violation_rate": 0.01, "chips": 2,
         "placement": "shared", "p99_ms": 30.0},
        {"goodput_rps": 90.0, "violation_rate": 0.30, "chips": 4,
         "placement": "dedicated"},
        {"goodput_rps": 60.0, "violation_rate": 0.04, "chips": 4,
         "placement": "dedicated", "p99_ms": 45.0},
    ])
    port = tplanner.CapacityModel.from_loadbench(bench)
    jax_ = jplanner.CapacityModel.from_loadbench(bench)
    assert port.__dict__ == jax_.__dict__
    assert (port.goodput_rps, port.chips, port.slo_ms) == (60.0, 4, 50.0)
    bad = _write_loadbench(tmp_path / "bad.json",
                           [{"goodput_rps": 10.0, "violation_rate": 0.9}])
    for lib in (tplanner, jplanner):
        with pytest.raises(ValueError):
            lib.CapacityModel.from_loadbench(bad)


def test_capacity_resolve_reads_only_the_configured_file(tmp_path, caplog):
    """The deliberate difference: a root holding a LOADBENCH.json and a
    bf16 PALLASBENCH.json (the JAX package fits and takes bf16 from
    them) leaves the port on the default; the configured file is fit,
    and a configured file that does not fit is a warning."""
    (tmp_path / "PALLASBENCH.json").write_text(
        json.dumps({"dtype": "bfloat16 in / f32 accumulate"}))
    _write_loadbench(tmp_path / "LOADBENCH.json",
                     [{"goodput_rps": 25.0, "violation_rate": 0.0}])
    jax_ = jplanner.CapacityModel.resolve(root=tmp_path)
    assert (jax_.goodput_rps, jax_.precision) == (25.0, "bf16")
    port = tplanner.CapacityModel.resolve(root=tmp_path)
    assert port == tplanner.CapacityModel.default()
    assert port.goodput_rps == tplanner.DEFAULT_GOODPUT_RPS
    assert tplanner.DEFAULT_GOODPUT_RPS == jplanner.DEFAULT_GOODPUT_RPS
    mine = _write_loadbench(tmp_path / "card.json",
                            [{"goodput_rps": 33.0, "violation_rate": 0.0}])
    port = tplanner.CapacityModel.resolve(mine, root=tmp_path)
    assert (port.goodput_rps, port.precision, port.source) == (
        33.0, "f32", mine)
    with caplog.at_level(logging.WARNING, logger=tplanner.log.name):
        assert tplanner.CapacityModel.resolve(
            str(tmp_path / "missing.json")).goodput_rps == 20.0
    assert any("missing.json" in r.getMessage() and r.levelno ==
               logging.WARNING for r in caplog.records)
    # the repo's own TPU figures are never read
    assert tplanner.CapacityModel.resolve(root=REPO) == (
        tplanner.CapacityModel.default())


def test_parse_federate_rollups_matches_jax():
    text = "\n".join([
        "# HELP rdp_fleet_model_arrival_rate per-model demand",
        'rdp_fleet_model_arrival_rate{model="a",replica="r1:1"} 12.5',
        'rdp_fleet_model_arrival_rate{model="a",replica="r2:1"} 7.5',
        'rdp_fleet_model_arrival_rate{model="b",replica="r1:1"} 5.0',
        'rdp_fleet_burn{stat="max"} 1.25',
        'rdp_fleet_burn{stat="mean"} 0.4',
        "rdp_fleet_replicas_live 2",
        'rdp_fleet_replicas_live{replica="x"} 9',
        "not a sample",
        "rdp_fleet_burn{stat=\"max\"} nan-ish",
    ])
    port = tplanner.parse_federate_rollups(text)
    assert port == jplanner.parse_federate_rollups(text)
    assert (port["demand_rps"], port["burn_max"], port["live"]) == (
        25.0, 1.25, 2)
    assert tplanner.parse_federate_rollups("") == (
        jplanner.parse_federate_rollups(""))


def test_plans_match_jax_over_a_grid():
    """plan() gives the same verdict in both packages over demand, live
    count, burn, headroom and bounds; each journals one planner.plan."""
    def script(pkg):
        lib = PKGS[pkg][1]
        cap = lib.CapacityModel(goodput_rps=50.0, chips=2, precision="bf16")
        out = []
        for demand in (0.0, 30.0, 120.0, 500.0):
            for live in (1, 2, 4):
                for burn in (0.0, 1.5):
                    for headroom in (0.01, 0.7, 1.0, 2.0):
                        out.append(lib.plan(
                            demand, live, capacity=cap, headroom=headroom,
                            burn_max=burn, min_replicas=1,
                            max_replicas=4).to_dict())
        return out

    runs = _both(script)
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][2]) == len(runs["port"][0]) == 96


def test_autoscaler_decisions_match_jax():
    def script(pkg):
        lib = PKGS[pkg][1]
        clock = _FakeClock()
        scaler = lib.Autoscaler(min_replicas=1, max_replicas=4,
                                sustain_s=5.0, cooldown_s=30.0, clock=clock)
        cap = lib.CapacityModel(goodput_rps=50.0)
        steps = [(100.0, 120.0, 2), (102.0, 120.0, 2), (103.0, 80.0, 2),
                 (104.0, 120.0, 2), (109.1, 120.0, 2), (115.0, 200.0, 3),
                 (139.2, 200.0, 3), (150.0, 0.0, 4), (156.0, 0.0, 4),
                 (175.0, 0.0, 3)]
        out = []
        for t, demand, live in steps:
            clock.t = t
            out.append(scaler.decide(lib.plan(demand, live, capacity=cap,
                                              headroom=1.0, max_replicas=4)))
        clock.t = 300.0
        out.append(scaler.decide(lib.plan(500.0, 4, capacity=cap,
                                          max_replicas=8)))
        out.append(scaler.decide(lib.plan(0.0, 1, capacity=cap,
                                          min_replicas=0)))
        return out, scaler.actions_total

    runs = _both(script)
    assert runs["port"] == runs["jax"]
    decisions = runs["port"][0][0]
    assert decisions[4] == "scale_up" and decisions[-2:] == [
        "hold_bounds", "hold_bounds"]
    for lib in (tplanner,):
        with pytest.raises(ValueError):
            lib.Autoscaler(min_replicas=0)
        with pytest.raises(ValueError):
            lib.Autoscaler(min_replicas=3, max_replicas=2)


def test_supervisor_round_trip_matches_jax():
    """The observe -> plan -> decide -> act loop over fakes: the same
    actions and details, the same journal evidence, and a scale-down with
    nothing drainable degrading to hold."""
    def script(pkg):
        lib = PKGS[pkg][1]
        clock = _FakeClock()
        demand = {"demand_rps": 120.0, "burn_max": 0.0, "live": 2}
        spawned, drained = [], []
        sup = lib.ElasticSupervisor(
            observe=lambda: dict(demand),
            scale_up=lambda: (spawned.append("new:1"), "new:1")[1],
            scale_down=drained.append, pick_drain=lambda: "old:1",
            capacity=lib.CapacityModel(goodput_rps=50.0),
            autoscaler=lib.Autoscaler(max_replicas=4, sustain_s=1.0,
                                      cooldown_s=2.0, clock=clock),
            headroom=1.0)
        out = []
        for t in (10.0, 11.1):
            clock.t = t
            out.append(sup.tick())
        demand.update(demand_rps=0.0, live=3)
        for t in (20.0, 21.2):
            clock.t = t
            out.append(sup.tick())
        idle = lib.ElasticSupervisor(
            observe=lambda: {"demand_rps": 0.0, "burn_max": 0.0, "live": 3},
            scale_up=lambda: "", scale_down=lambda ep: None,
            pick_drain=lambda: None,
            capacity=lib.CapacityModel(goodput_rps=50.0),
            autoscaler=lib.Autoscaler(sustain_s=0.0, cooldown_s=0.0,
                                      clock=clock))
        for t in (30.0, 31.0):
            clock.t = t
            out.append(idle.tick())
        snap = sup.snapshot()
        return out, spawned, drained, snap

    runs = _both(script)
    assert runs["port"] == runs["jax"]
    ticks = runs["port"][0][0]
    assert [t["action"] for t in ticks] == [
        "hold_sustain", "scale_up", "hold_sustain", "scale_down", "hold_sustain",
        "hold"]
    assert ticks[-1]["detail"] == "no drainable member"
    kinds = [k for k, _ in runs["port"][2]]
    assert kinds.count("autoscaler.action") == 2 and "planner.plan" in kinds


# -- the front-end's elastic surfaces ------------------------------------------------


class _FakeTarget:
    def __init__(self, replica):
        self.replica = replica


class _FakeFederator:
    def __init__(self, payloads):
        self.payloads = payloads

    def journal_payloads(self):
        return self.payloads

    def stop(self):
        pass


def _frontend_over_fakes(pkg):
    lib, _, _, _, cfg_mod, fe_lib = PKGS[pkg]
    router = lib.FleetRouter(["a:1"], channel_factory=lambda ep: None,
                             registry=lib.LeaseRegistry(ttl_s=10.0))
    return fe_lib.FleetFrontend(router, cfg_mod.ServerConfig(
        fleet_replicas="a:1"), registry=router.registry)


def test_frontend_stats_and_events_match_jax():
    """The gossip surface (frontend_stats) and the fleet-wide
    /debug/events merge over canned member journals, in both packages."""
    now = time.time()
    payloads = [
        (_FakeTarget("r1:1"), {
            "host": "h1", "role": "replica", "dropped_total": 0,
            "events": [
                {"seq": 5, "unix_ts": now - 10.0, "kind": "fleet.membership",
                 "host": "h1", "role": "replica", "attrs": {}},
                {"seq": 6, "unix_ts": now + 10.0,
                 "kind": "serving.rollout.transition", "host": "h1",
                 "role": "replica", "attrs": {}}]}, 0.0, True),
        (_FakeTarget("r2:1"), {
            "host": "h2", "role": "replica", "dropped_total": 2,
            "events": [
                {"seq": 9, "unix_ts": now - 10.0,
                 "kind": "breaker.transition", "host": "h2",
                 "role": "replica", "attrs": {}}]}, 31.0, False),
        (_FakeTarget("r3:1"), None, 0.0, False),
    ]
    out = {}
    for pkg in PKGS:
        fe = _frontend_over_fakes(pkg)
        journal_lib = PKGS[pkg][3]
        try:
            fe.registry.register("leased:1", metrics_port=9100)
            fe.router.sync_leases()
            stats = fe.frontend_stats()
            cursor = journal_lib.JOURNAL.snapshot()["next_cursor"]
            journal_lib.JOURNAL.append("frontend.local", marker="own")
            fe.federator = _FakeFederator(payloads)
            events = fe.events_debug(since=cursor)
        finally:
            fe.close()
        for key in ("pid", "host", "role"):
            stats.pop(key)
        for e in events["events"]:
            if e["source"] == "frontend":
                for key in ("seq", "unix_ts", "host", "role"):
                    e.pop(key, None)
        for s in events["sources"]:
            if s["source"] == "frontend":
                s.pop("host")
                s.pop("role")
        events.pop("next_cursor")
        events.pop("since")
        out[pkg] = (stats, events)
    for stats, _ in out.values():
        stats["leases"]["leased:1"]["expires_in_s"] = round(
            stats["leases"]["leased:1"]["expires_in_s"])
    assert out["port"] == out["jax"]
    assert [e["kind"] for e in out["port"][1]["events"]] == [
        "fleet.membership", "breaker.transition", "frontend.local",
        "serving.rollout.transition"]


def test_elastic_frontend_allows_empty_seed_list():
    server, fe = tfrontend.build_frontend(config.ServerConfig(
        address="localhost:0", fleet_replicas="", fleet_elastic=True))
    try:
        assert fe.registry is not None and fe.bound_port > 0
        assert fe.router.live_count == 0
    finally:
        server.stop(grace=None)
        fe.close()


# -- a real front-end and a real replica, as processes ---------------------------


def test_spawned_replica_leases_into_a_spawned_frontend(tmp_path):
    """``spawn_local_frontends`` boots an elastic front-end and
    ``spawn_local_replicas(device="cpu")`` a replica registered with it:
    the replica joins by its lease alone, serves frames through the
    front-end as it does direct, and on SIGTERM leaves its lease."""
    uri = replica.register_tiny_model(tmp_path / "mlruns", img_size=64)
    fes = tfrontend.spawn_local_frontends(1, elastic=True, lease_ttl_s=2.0,
                                          poll_s=0.1, metrics_port=0,
                                          replica_device="cpu")
    reps = []
    try:
        reps = replica.spawn_local_replicas(
            1, uri, img_size=64, device="cpu", registrars=fes[0].endpoint,
            lease_ttl_s=2.0)
        replica.wait_serving([reps[0].endpoint])
        channel = grpc.insecure_channel(fes[0].endpoint)
        stats_stub = tfleet.ReplicaStatsStub(channel)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = tfleet.fetch_replica_stats(stats_stub, 5.0)
            if stats["live_replicas"] == 1:
                break
            time.sleep(0.1)
        assert stats["live_replicas"] == 1
        assert stats["leases"][reps[0].endpoint]["state"] == "active"
        rng = np.random.default_rng(3)
        reqs = []
        for _ in range(3):
            rgb, _, depth = render_scene(rng, 96, 128)
            reqs.append(client.encode_request(rgb[..., ::-1], depth,
                                              fmt="raw", mask_format=1))

        def run(endpoint):
            ch = grpc.insecure_channel(endpoint)
            try:
                out = []
                for r in vision_grpc.VisionAnalysisServiceStub(
                        ch).AnalyzeActuatorPerformance(iter(reqs),
                                                       timeout=120):
                    assert r.status.startswith(("OK", "DEGRADED")), r.status
                    r.proc_time_ms = 0.0
                    out.append(r.SerializeToString())
                return out
            finally:
                ch.close()

        assert run(fes[0].endpoint) == run(reps[0].endpoint)
        reps[0].terminate()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = tfleet.fetch_replica_stats(stats_stub, 5.0)
            if stats["leases"][reps[0].endpoint]["state"] == "left":
                break
            time.sleep(0.1)
        assert stats["leases"][reps[0].endpoint]["state"] == "left"
        channel.close()
    finally:
        replica.stop_replicas(reps)
        tfrontend.stop_frontends(fes)
