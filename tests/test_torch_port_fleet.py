"""The port's serving fleet (serving/fleet.py, serving/frontend.py and the
server's stats RPC) against the JAX package's, on the CPU.

- placement units: the same pick / release / weight sequences over fake
  replicas give the same endpoints in both packages, and the same
  controller weights and actions;
- the stats RPC: the wire bytes of either package's server are equal for
  one payload, each package's stub reads the other's server, and the
  port servicer's payload has every key of the JAX servicer's;
- membership: health drop-out and half-open rejoin against a health-only
  server, one fake clock per package, step for step equal;
- the live fleet on in-process port replicas: a one-replica fleet answers
  bit for bit as the replica direct, through the port's front-end and
  through the JAX package's; a replica killed with a frame pinned inside
  it fails that frame over with no frame dropped; an empty ring aborts
  UNAVAILABLE;
- importing ``serving.frontend`` loads no module of the port's ``ops/``
  or ``models/`` (and no torch).

Tolerances, fixed before measuring: none. Endpoints, weights, counts,
payloads and response bytes are compared exactly.
"""

import json
import queue
import subprocess
import sys
import time
from concurrent import futures
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.serving import fleet as jfleet
from robotic_discovery_platform_tpu.serving import frontend as jfrontend
from robotic_discovery_platform_tpu.serving import health as jhealth
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.resilience import faults
from robotic_discovery_platform_tpu_torch.serving import client
from robotic_discovery_platform_tpu_torch.serving import fleet as tfleet
from robotic_discovery_platform_tpu_torch.serving import frontend as tfrontend
from robotic_discovery_platform_tpu_torch.serving import grpc_service
from robotic_discovery_platform_tpu_torch.serving import health as thealth
from robotic_discovery_platform_tpu_torch.serving import replica
from robotic_discovery_platform_tpu_torch.serving.proto import vision_grpc
from robotic_discovery_platform_tpu_torch.utils import config

REPO = Path(__file__).resolve().parent.parent
SIZE, H, W = 64, 120, 160
PACKAGES = {"port": (tfleet, thealth), "jax": (jfleet, jhealth)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """One tiny registered model (base 8, float32) every replica of this
    module serves: shared weights make the paths comparable bit for
    bit."""
    return replica.register_tiny_model(tmp_path_factory.mktemp("mlruns"),
                                       img_size=SIZE)


def _requests(n: int, seed: int = 11) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rgb, _, depth = render_scene(rng, H, W)
        out.append(client.encode_request(rgb[..., ::-1], depth, fmt="raw",
                                         mask_format=1))
    return out


def _replica_cfg(uri, tmp_path, name, port=0, **fields):
    return config.ServerConfig(
        address=f"localhost:{port}", tracking_uri=uri, model_img_size=SIZE,
        metrics_csv=str(tmp_path / f"{name}.csv"), metrics_flush_every=1000,
        calibration_path=str(tmp_path / "missing.npz"), reload_poll_s=0.0,
        **fields)


def _boot_replica(uri, tmp_path, name, port=0, **fields):
    server, servicer = grpc_service.build_server(
        _replica_cfg(uri, tmp_path, name, port, **fields), device="cpu")
    server.start()
    return server, servicer, f"localhost:{servicer.bound_port}"


def _frontend_cfg(package, endpoints, **overrides):
    cfg_mod = config if package == "port" else jconfig
    return cfg_mod.ServerConfig(
        address="localhost:0", fleet_replicas=",".join(endpoints),
        fleet_poll_s=overrides.pop("fleet_poll_s", 0.1),
        fleet_breaker_failures=overrides.pop("fleet_breaker_failures", 1),
        fleet_breaker_reset_s=overrides.pop("fleet_breaker_reset_s", 0.5),
        **overrides)


def _boot_frontend(package, endpoints, **overrides):
    lib = tfrontend if package == "port" else jfrontend
    cfg = _frontend_cfg(package, endpoints, **overrides)
    server, fe = lib.build_frontend(cfg)
    server.start()
    return server, fe, f"localhost:{fe.bound_port}"


def _stream(endpoint: str, reqs: list) -> list:
    """Every response of one stream of ``reqs``, as wire bytes."""
    channel = grpc.insecure_channel(endpoint)
    try:
        stub = vision_grpc.VisionAnalysisServiceStub(channel)
        return [r.SerializeToString() for r in
                stub.AnalyzeActuatorPerformance(iter(reqs), timeout=120)]
    finally:
        channel.close()


# -- placement units ---------------------------------------------------------


def _fake_router(lib, endpoints=("a:1", "b:2", "c:3"), **kw):
    router = lib.FleetRouter(list(endpoints), **kw)
    for r in router.replicas:
        r.serving = True
    return router


@pytest.mark.parametrize("name,env", [
    ("resolve_fleet_replicas", "RDP_FLEET_REPLICAS"),
    ("resolve_fleet_registrars", "RDP_FLEET_REGISTRARS"),
    ("resolve_fleet_peers", "RDP_FLEET_PEERS"),
])
def test_list_resolvers_match_jax(name, env, monkeypatch):
    for value in (None, "x:9,y:8", " "):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
        for configured in ("", " a:1, b:2 ,", "a:1"):
            assert (getattr(tfleet, name)(configured)
                    == getattr(jfleet, name)(configured))


def test_flag_resolvers_match_jax(monkeypatch):
    for value in (None, "1", "off", "yes"):
        for var in ("RDP_FLEET_ELASTIC", "RDP_FLEET_ADVERTISE"):
            if value is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, value)
        for configured in (True, False):
            assert (tfleet.resolve_fleet_elastic(configured)
                    == jfleet.resolve_fleet_elastic(configured))
        for configured, default in (("", ""), ("", "localhost:5"),
                                    (" h:1 ", "localhost:5")):
            assert (tfleet.resolve_fleet_advertise(configured, default)
                    == jfleet.resolve_fleet_advertise(configured, default))


def _placement_script(lib) -> list:
    """One sequence of picks, releases, loads, weights and exclusions;
    returns every pick's endpoint (None for no pick)."""
    out = []
    router = _fake_router(lib)
    for _ in range(4):  # idle picks walk the ring
        r = router.pick()
        out.append(r.endpoint)
        router.release(r)
    router.replicas[0].inflight, router.replicas[1].inflight = 4, 1
    router.replicas[2].inflight = 3
    out.append(router.pick().endpoint)  # least loaded
    router.replicas[1].weight = 0.2  # de-weighted looks busier
    out.append(router.pick().endpoint)
    router.replicas[0].serving = False
    out.append(getattr(router.pick(exclude=router.replicas[2]), "endpoint",
                       None))
    router.replicas[1].draining = True
    out.append(getattr(router.pick(exclude=router.replicas[2]), "endpoint",
                       None))
    router.set_external_load({"c:3": 7})
    router.replicas[1].draining = False
    out.append(router.pick().endpoint)
    out.append([r.inflight for r in router.replicas])
    out.append([r.placements for r in router.replicas])
    out.append(router.placement_loads())
    return out


def test_ring_and_least_loaded_picks_match_jax():
    assert _placement_script(tfleet) == _placement_script(jfleet)
    assert _placement_script(tfleet)[:4] == ["a:1", "b:2", "c:3", "a:1"]


def test_controller_weights_match_jax():
    def script(lib):
        c = lib.FleetController(burn_high=0.8, weight_floor=0.1)
        router = _fake_router(lib, ("a:1", "b:2"))
        trail = [c.target_weight(b) for b in (0.0, 0.8, 1.6, 100.0)]
        for burns in ((1.6, 0.0), (1.62, 0.9), (0.2, 5.0), (0.0, 0.0)):
            for r, b in zip(router.replicas, burns):
                r.burn = b
            c.rebalance(router.replicas)
            trail.append(([r.weight for r in router.replicas],
                          c.actions_total))
        return trail

    assert script(tfleet) == script(jfleet)
    with pytest.raises(ValueError):
        tfleet.FleetController(weight_floor=0.0)
    with pytest.raises(ValueError):
        tfleet.FleetRouter([])
    with pytest.raises(ValueError):
        tfrontend.build_frontend(config.ServerConfig(fleet_replicas=""))


# -- stats RPC ---------------------------------------------------------------


def _stats_server(lib, payload, drained):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    lib.add_replica_stats_to_server(server, lambda: payload,
                                    drain=drained.append)
    port = server.add_insecure_port("localhost:0")
    server.start()
    return server, f"localhost:{port}"


def test_stats_rpc_wire_both_ways():
    """Either package's stub reads either package's server, the Get
    bytes are equal for one payload, and Drain carries the flag."""
    payload = {"burn": 1.5, "inflight_streams": 2, "frames_total": 7,
               "models": {"seg": {"frames": 7, "rate": 0.5}},
               "version": 3, "draining": False}
    raw, drained = {}, {"port": [], "jax": []}
    servers = {p: _stats_server(PACKAGES[p][0], payload, drained[p])
               for p in PACKAGES}
    try:
        for server_pkg, (_, endpoint) in servers.items():
            channel = grpc.insecure_channel(endpoint)
            try:
                for stub_pkg, (lib, _) in PACKAGES.items():
                    stub = lib.ReplicaStatsStub(channel)
                    assert lib.fetch_replica_stats(stub, 5.0) == payload
                    raw[server_pkg] = stub.Get(b"", timeout=5.0)
                    stub.Drain(json.dumps({"draining": stub_pkg == "port"})
                               .encode(), timeout=5.0)
            finally:
                channel.close()
        assert raw["port"] == raw["jax"]
        assert drained == {"port": [True, False], "jax": [True, False]}
    finally:
        for server, _ in servers.values():
            server.stop(grace=None)


def test_replica_stats_has_every_key_of_the_jax_servicer(registry, tmp_path):
    """The port servicer's payload keys are the JAX servicer's; one card
    and no DeviceRouter: chips 1, none quarantined; frames count."""
    from robotic_discovery_platform_tpu import tracking as jtracking

    server, servicer, endpoint = _boot_replica(registry, tmp_path, "stats")
    prev = jtracking.get_tracking_uri()
    try:
        jcfg = jconfig.ServerConfig(
            tracking_uri=registry, model_img_size=SIZE,
            metrics_csv=str(tmp_path / "j.csv"), reload_poll_s=0.0,
            calibration_path=str(tmp_path / "missing.npz"))
        model, variables, version = jserver.resolve_serving_model(jcfg)
        jservice = jserver.VisionAnalysisService(
            model, variables, None, 0.001, jcfg, version=version)
        try:
            jstats = jservice.replica_stats()
        finally:
            jservice.close()
        channel = grpc.insecure_channel(endpoint)
        try:
            stats = jfleet.fetch_replica_stats(
                jfleet.ReplicaStatsStub(channel), timeout_s=10.0)
            assert set(stats) == set(jstats)
            assert stats["chips"] == 1 and stats["quarantined_chips"] == 0
            assert (stats["frames_total"], stats["inflight_streams"],
                    stats["burn"], stats["draining"]) == (0, 0, 0.0, False)
            assert stats["version"] == jstats["version"] == version
            _stream(endpoint, _requests(2))
            stats = tfleet.fetch_replica_stats(
                tfleet.ReplicaStatsStub(channel), timeout_s=10.0)
            assert stats["frames_total"] == 2
            assert stats["models"]["seg"]["frames"] == 2
            # the single-model replica's arrival rate (the JAX servicer's
            # single model reports 0.0): a repair for the fleet planner
            assert jstats["models"]["seg"]["rate"] == 0.0
            servicer._arrivals._cur_start -= 2 * servicer._arrivals.interval_s
            stats = tfleet.fetch_replica_stats(
                tfleet.ReplicaStatsStub(channel), timeout_s=10.0)
            assert stats["models"]["seg"]["rate"] > 0.0
        finally:
            channel.close()
    finally:
        jtracking.set_tracking_uri(prev)
        server.stop(grace=None)
        servicer.close()


# -- health-gated membership ---------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def health_servers():
    """One health-only gRPC server per package (no vision service, no
    stats): the membership poller's world model of a replica."""
    out = {}
    for pkg, (_, health_lib) in PACKAGES.items():
        health = health_lib.HealthServicer()
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        health_lib.add_HealthServicer_to_server(health, server)
        port = server.add_insecure_port("localhost:0")
        server.start()
        out[pkg] = (health, f"localhost:{port}", server)
    yield out
    for _, _, server in out.values():
        server.stop(grace=None)


def test_membership_drop_out_and_half_open_rejoin_match_jax(health_servers):
    def script(pkg):
        lib, health_lib = PACKAGES[pkg]
        health, endpoint, _ = health_servers[pkg]
        clock, seen = _FakeClock(), []
        router = lib.FleetRouter([endpoint], breaker_failures=2,
                                 breaker_reset_s=5.0, clock=clock,
                                 on_membership=seen.append)
        r = router.replicas[0]
        trail = []

        def tick():
            trail.append((router.poll_once(), r.placeable, r.serving,
                          r.breaker.state, router.quarantined_count))

        try:
            tick()
            health.set("", health_lib.SERVING)
            tick()
            health.set("", health_lib.NOT_SERVING)
            tick()
            tick()
            health.set("", health_lib.SERVING)
            tick()
            clock.t += 5.1
            tick()
            router.on_stream_error(r, RuntimeError("stream died"))
            trail.append((r.placeable, router.pick() is None))
        finally:
            router.stop()
        return trail, seen

    port, jax_ = script("port"), script("jax")
    assert port == jax_
    assert port[0][-2] == (1, True, True, "closed", 0)


# -- live fleet ----------------------------------------------------------------


@pytest.mark.parametrize("frontend_pkg", ["port", "jax"])
def test_one_replica_fleet_is_bitwise_identical_to_direct(
        registry, tmp_path, frontend_pkg):
    """The one-replica fleet (either package's front-end over a port
    replica) relays the exact bytes the replica answers direct."""
    reqs = _requests(4)
    r_server, r_servicer, r_endpoint = _boot_replica(registry, tmp_path, "r")
    f_server = fe = None
    try:
        direct = _stream(r_endpoint, reqs)
        f_server, fe, f_endpoint = _boot_frontend(frontend_pkg, [r_endpoint])
        assert fe.router.wait_live(1, timeout_s=10)
        assert fe.health.get("") == thealth.SERVING
        fleet = _stream(f_endpoint, reqs)
        assert len(direct) == len(fleet) == 4
        # the response bytes, proc_time_ms left out (each run's own)
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            vision_pb2,
        )

        def fields(blob):
            msg = vision_pb2.AnalysisResponse.FromString(blob)
            assert msg.status.startswith(("OK", "DEGRADED")), msg.status
            msg.proc_time_ms = 0.0
            return msg.SerializeToString()

        assert [fields(b) for b in direct] == [fields(b) for b in fleet]
        assert fe.router.replicas[0].frames == 4
        assert fe.router.failovers_total == 0
        # the front-end reads the port replica's stats over its wire: the
        # 4 direct frames and the 4 relayed ones
        fe.router.poll_once()
        assert fe.router.replicas[0].stats["frames_total"] == 8
    finally:
        if f_server is not None:
            f_server.stop(grace=None)
            fe.close()
        r_server.stop(grace=None)
        r_servicer.close()


def test_replica_kill_fails_over_with_no_frame_dropped(registry, tmp_path,
                                                       monkeypatch):
    """A frame pinned inside the replica a stream is placed on (a slow
    fault at serving.analyze) while that replica is stopped: the frame is
    answered by the survivor or error-completed, never lost; the stream
    goes on on the survivor; the ledger counts every accepted frame."""
    s1, sv1, ep1 = _boot_replica(registry, tmp_path, "r1")
    s2, sv2, ep2 = _boot_replica(registry, tmp_path, "r2")
    servers = {ep1: (s1, sv1), ep2: (s2, sv2)}
    f_server = fe = channel = None
    try:
        f_server, fe, f_endpoint = _boot_frontend("port", [ep1, ep2])
        assert fe.router.wait_live(2, timeout_s=10)
        reqs = _requests(3, seed=21)
        channel = grpc.insecure_channel(f_endpoint)
        stub = vision_grpc.VisionAnalysisServiceStub(channel)
        outbox: queue.Queue = queue.Queue()

        def gen():
            while (item := outbox.get()) is not None:
                yield item

        responses = stub.AnalyzeActuatorPerformance(gen())
        outbox.put(reqs[0])
        assert next(responses).status.startswith(("OK", "DEGRADED"))
        placed = [r for r in fe.router.replicas if r.inflight > 0]
        assert len(placed) == 1
        victim = placed[0]
        monkeypatch.setenv("RDP_FAULT_SLOW_S", "2.0")
        faults.configure_faults("serving.analyze:slow:1")
        try:
            outbox.put(reqs[1])
            deadline = time.monotonic() + 10.0
            while (faults.fired("serving.analyze") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert faults.fired("serving.analyze") >= 1
            servers[victim.endpoint][0].stop(grace=None)
            r1 = next(responses)
        finally:
            faults.configure_faults(None)
        assert r1.status.startswith(("OK", "DEGRADED", "ERROR"))
        assert fe.router.failovers_total >= 1
        assert not victim.placeable
        outbox.put(reqs[2])
        assert next(responses).status.startswith(("OK", "DEGRADED"))
        outbox.put(None)
        assert list(responses) == []
        relayed = sum(r.frames for r in fe.router.replicas)
        errored = fe.router.failover_frames_error_completed
        assert relayed + errored >= 3
        assert fe.router.failover_frames_rerouted + errored >= 1
    finally:
        if channel is not None:
            channel.close()
        if f_server is not None:
            f_server.stop(grace=None)
            fe.close()
        for server, servicer in servers.values():
            server.stop(grace=None)
            servicer.close()


def test_frontend_aborts_with_no_live_replica():
    f_server, fe, f_endpoint = _boot_frontend("port", ["localhost:1"])
    try:
        time.sleep(0.3)
        assert fe.router.live_count == 0
        assert fe.health.get("") == thealth.NOT_SERVING
        with pytest.raises(grpc.RpcError) as err:
            _stream(f_endpoint, _requests(1, seed=5))
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    finally:
        f_server.stop(grace=None)
        fe.close()


def test_frontend_import_loads_no_ops_or_models():
    """The front-end routes bytes: importing it (and the fleet, planner
    and federation it rides on) loads nothing of the port's ops/ or
    models/, and no torch."""
    code = ("import json, sys\n"
            "import robotic_discovery_platform_tpu_torch.serving.frontend\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    pkg = "robotic_discovery_platform_tpu_torch"
    for module in ("serving.fleet", "serving.planner",
                   "observability.federation", "serving.frontend"):
        assert f"{pkg}.{module}" in loaded
    assert [m for m in loaded if m.startswith((f"{pkg}.ops", f"{pkg}.models"))
            ] == []
    assert "torch" not in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]


def test_server_config_takes_the_fleet_fields():
    """The 21 fleet_*, autoscaler_* and planner_* fields with the JAX
    package's names and defaults; from_dict and the flags take them."""
    names = [f for f in jconfig.ServerConfig.__dataclass_fields__
             if f.startswith(("fleet_", "autoscaler_", "planner_"))]
    assert len(names) == 21
    port, jax_ = config.ServerConfig(), jconfig.ServerConfig()
    assert ({n: getattr(port, n) for n in names}
            == {n: getattr(jax_, n) for n in names})
    made = config.from_dict(config.ServerConfig, {
        "fleet_replicas": "a:1", "fleet_elastic": True,
        "autoscaler_max_replicas": 2, "planner_headroom": 0.5})
    assert (made.fleet_replicas, made.fleet_elastic,
            made.autoscaler_max_replicas, made.planner_headroom) == (
                "a:1", True, 2, 0.5)
    parsed = config.parse_config(["--server.fleet_poll_s", "0.25",
                                  "--server.autoscaler_enabled", "true"])
    assert parsed.server.fleet_poll_s == 0.25
    assert parsed.server.autoscaler_enabled is True
