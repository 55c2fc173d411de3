"""A server that can be deployed, on the CPU: the port's hot reload,
readiness, drain, health service and frame instruments
(``serving/server.py``, ``serving/grpc_service.py``, ``serving/health.py``)
against the JAX package's ``serving/server.py``.

One file store, written by the JAX package's tracking and read by both
packages, holds versions 1 and 2. A JAX servicer and a port servicer both
start at version 1; the ``staging`` alias moves; both ``maybe_reload()``
swap to version 2 and serve it, directly and batched. The port
counterparts of the JAX package's reload tests (``tests/test_service.py``:
mid-stream, the dispatcher swap, a grace timer that does not block
``close``, a reloader that leaves global tracking alone) and its drain
and health test (``tests/test_resilience.py``) follow.

Tolerances, those of tests/test_torch_port_serving.py, fixed before
measuring: statuses, coverage and packed mask payloads identical;
curvature rtol 1e-3. Capture counts and weights: exact.
"""

import copy
import dataclasses
import gc
import queue
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from robotic_discovery_platform_tpu import tracking as jtracking  # noqa: E402
from robotic_discovery_platform_tpu.analysis import (  # noqa: E402
    recompile as jrecompile,
)
from robotic_discovery_platform_tpu.models.unet import (  # noqa: E402
    build_unet,
    init_unet,
)
from robotic_discovery_platform_tpu.ops import pipeline as jpipe  # noqa: E402
from robotic_discovery_platform_tpu.serving import server as jserver  # noqa: E402
from robotic_discovery_platform_tpu.utils import config as jconfig  # noqa: E402
from robotic_discovery_platform_tpu_torch import tracking  # noqa: E402
from robotic_discovery_platform_tpu_torch.analysis import (  # noqa: E402
    recompile,
)
from robotic_discovery_platform_tpu_torch.io.frames import (  # noqa: E402
    render_scene,
)
from robotic_discovery_platform_tpu_torch.observability import (  # noqa: E402
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.observability import (  # noqa: E402
    journal,
)
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe  # noqa: E402
from robotic_discovery_platform_tpu_torch.ops import quant  # noqa: E402
from robotic_discovery_platform_tpu_torch.ops.unet_infer import (  # noqa: E402
    FoldedUNet,
)
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    grpc_service,
    health,
    ingest,
)
from robotic_discovery_platform_tpu_torch.serving import (  # noqa: E402
    server as tserver,
)
from robotic_discovery_platform_tpu_torch.utils import config  # noqa: E402

NAME = "Actuator-Segmenter"
H, W, SIZE = 120, 160, 64
JCFG = jconfig.ModelConfig(base_features=8, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs in
    several worker processes at once, and torch's pool of one thread per
    core, oversubscribed, waits on itself at every small op
    (tests/test_torch_port_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(seed: int) -> dict:
    """The serving test's recipe (tests/test_torch_port_serving.py):
    BatchNorm statistics from a numpy seed and the head bias at frame 0's
    median logit, so masks are structured."""
    model = build_unet(JCFG)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, SIZE))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    rgb, _, _ = render_scene(np.random.default_rng(100), H, W)
    x = jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return variables


def _register(uri: str, variables: dict, cfg=JCFG) -> int:
    """The next version of NAME in the store at ``uri`` (written by the
    JAX package's tracking), as the ``staging`` alias."""
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    try:
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(variables, cfg,
                                          registered_model_name=NAME)
        jtracking.Client().set_registered_model_alias(NAME, "staging",
                                                      version)
    finally:
        jtracking.set_tracking_uri(prev)
    return version


def _frames(n: int = 4):
    rng = np.random.default_rng(100)
    return [render_scene(rng, H, W)[::2] for _ in range(n)]  # (rgb, depth)


def _cfgs(uri: str, tmp_path, **fields):
    common = dict(address="localhost:0", tracking_uri=uri,
                  model_img_size=SIZE,
                  calibration_path=str(tmp_path / "none.npz"),
                  reload_poll_s=0.0, **fields)
    return (config.ServerConfig(metrics_csv=str(tmp_path / "p.csv"),
                                **common),
            jconfig.ServerConfig(metrics_csv=str(tmp_path / "j.csv"),
                                 **common))


def _jax_service(jcfg):
    prev = jtracking.get_tracking_uri()
    try:
        model, variables, version = jserver.resolve_serving_model(jcfg)
    finally:
        jtracking.set_tracking_uri(prev)
    return jserver.VisionAnalysisService(model, variables, None, 0.001, jcfg,
                                         version=version)


def _jax_answers(jservice, frames):
    """The JAX servicer's answers through its frame path: (status, packed
    mask bits, coverage, mean and max curvature) per frame."""
    out = []
    for rgb, depth in frames:
        res = jservice._analyze_frame(rgb, depth, mask_format=1)
        out.append(("OK" if res.valid else tserver.STATUS_DEGRADED,
                    res.mask_png, float(np.float32(res.coverage)),
                    res.mean_k, res.max_k))
    return out


def _port_answers(service, frames):
    out = []
    for resp in service.analyze_stream(iter(
            [ingest.raw_request(rgb, depth, mask_format=1)
             for rgb, depth in frames])):
        out.append((resp.status, resp.mask, resp.mask_coverage,
                    resp.mean_curvature, resp.max_curvature))
    return out


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g[0] == w[0]
        assert g[1] == w[1]  # packed bits payload, byte for byte
        assert g[2] == w[2]
        if g[0] == "OK":
            np.testing.assert_allclose(g[3:], w[3:], rtol=1e-3, atol=0.0)


def _nonzero_counts(snapshot: dict) -> dict:
    return {name: [e["traces"] for e in entries if e["traces"]]
            for name, entries in snapshot.items()
            if any(e["traces"] for e in entries)}


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_reload_serves_the_new_version_as_the_jax_package(batched, tmp_path):
    """Both servicers start at version 1 and answer alike; the alias
    moves; both reloads swap to version 2 (the same ``current_version``)
    and both answer version 2 alike. The capture guard's per-instance
    counts after the reload equal the JAX package's trace counts; the
    port's registry keeps every generation's entries, as the JAX one does
    (it grows by 2 frame-analyzer entries per direct generation where the
    JAX one grows by 1: the port builds its coefficient lane's direct
    analyzer with each generation, at 0 captures until a coefficient frame
    arrives)."""
    uri = f"file:{tmp_path}/mlruns"
    v1 = _register(uri, _variables(0))
    fields = dict(batch_window_ms=5.0, max_batch=2) if batched else {}
    pcfg, jcfg = _cfgs(uri, tmp_path, **fields)
    frames = _frames()
    recompile.reset()
    jrecompile.reset()
    service = tserver.build_service(pcfg, device="cpu")
    jservice = _jax_service(jcfg)
    try:
        service.warmup(W, H)
        jservice.warmup(W, H)
        assert service.current_version == jservice.current_version == v1
        before = _port_answers(service, frames)
        _same(before, _jax_answers(jservice, frames))
        v2 = _register(uri, _variables(1))
        old_dispatcher = service.dispatcher
        assert service.maybe_reload() and jservice.maybe_reload()
        assert service.current_version == jservice.current_version == v2
        assert (service.dispatcher is not old_dispatcher) == batched
        after = _port_answers(service, frames)
        _same(after, _jax_answers(jservice, frames))
        assert [a[1] for a in after] != [b[1] for b in before]
        got = _nonzero_counts(recompile.snapshot())
        want = _nonzero_counts(jrecompile.snapshot())
        assert got == want
        assert want == ({"pipeline.batch_analyzer": [2, 2]} if batched
                        else {"pipeline.frame_analyzer": [1, 1]})
        grows = {n: len(e) for n, e in recompile.snapshot().items()}
        jgrows = {n: len(e) for n, e in jrecompile.snapshot().items()}
        assert grows["pipeline.frame_analyzer"] == 4
        assert jgrows["pipeline.frame_analyzer"] == 2
        assert recompile.over_budget() == jrecompile.over_budget() == {}
    finally:
        service.close()
        jservice.close()
        recompile.reset()
        jrecompile.reset()


# -- the port counterparts of the JAX package's reload tests ---------------------

BASE = None


def _biased(bias: float) -> dict:
    """``_variables(0)`` with every head bias set to ``bias``: -10 gives
    empty masks, +10 full ones (the JAX tests' observable swap)."""
    global BASE
    if BASE is None:
        BASE = _variables(0)
    v = copy.deepcopy(BASE)
    v["params"]["Conv_0"]["bias"] = np.full_like(
        v["params"]["Conv_0"]["bias"], bias)
    return v


def _coverage(service, frames):
    return [r.mask_coverage for r in _port_answers(service, frames)]


def test_hot_reload_mid_stream(tmp_path):
    """``tests/test_service.py::test_hot_reload_mid_stream``: one stream
    stays open while the poller swaps the model underneath; it never
    drops, and its frames switch from empty to full masks."""
    uri = f"file:{tmp_path}/mlruns"
    v1 = _register(uri, _biased(-10.0))
    pcfg, _ = _cfgs(uri, tmp_path)
    pcfg = dataclasses.replace(pcfg, reload_poll_s=0.05)
    server, service = grpc_service.build_server(pcfg, device="cpu")
    rgb, depth = _frames(1)[0]
    q: queue.Queue = queue.Queue()

    def requests():
        while (item := q.get()) is not None:
            yield item

    try:
        assert service.current_version == v1
        call = service.analyze_stream(requests())
        responses = []
        for _ in range(2):
            q.put(ingest.raw_request(rgb, depth))
            responses.append(next(call))
        v2 = _register(uri, _biased(10.0))
        deadline = time.time() + 60
        while service.current_version != v2 and time.time() < deadline:
            time.sleep(0.05)
        for _ in range(2):
            q.put(ingest.raw_request(rgb, depth))
            responses.append(next(call))
        q.put(None)
        responses.extend(call)
        assert len(responses) == 4
        assert all(not r.status.startswith("ERROR") for r in responses)
        assert service.current_version == v2 > v1
        assert responses[0].mask_coverage < 1.0
        assert responses[1].mask_coverage < 1.0
        assert responses[3].mask_coverage > 99.0
    finally:
        server.stop(grace=None)
        service.close()


def _k():
    return ingest.default_intrinsics(W, H).astype(np.float32)


def _submit_coverage(dispatcher, rgb, depth) -> float:
    packed = dispatcher.submit(rgb, depth, _k(), 0.001)
    try:
        return packed.scalars()[0]
    finally:
        packed.release()


def test_hot_reload_with_batching_swaps_dispatcher(tmp_path):
    """``tests/test_service.py::test_hot_reload_with_batching_swaps_
    dispatcher``: the reload builds a new dispatcher; the old one serves
    through its grace window, then a stopped one refuses cleanly."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _biased(-10.0))
    pcfg, _ = _cfgs(uri, tmp_path, batch_window_ms=5.0, max_batch=2)
    server, service = grpc_service.build_server(pcfg, device="cpu")
    rgb, depth = _frames(1)[0]
    try:
        old = service.dispatcher
        assert _submit_coverage(old, rgb, depth) < 1.0
        v2 = _register(uri, _biased(10.0))
        assert service.maybe_reload()
        assert service.current_version == v2
        assert service.dispatcher is not old
        assert _submit_coverage(old, rgb, depth) < 1.0  # in its grace
        assert _submit_coverage(service.dispatcher, rgb, depth) > 99.0
        old.stop()
        with pytest.raises(RuntimeError, match="dispatcher stopped"):
            old.submit(rgb, depth, _k(), 0.001)
    finally:
        server.stop(grace=None)
        service.close()


def test_reload_grace_timer_does_not_block_close(tmp_path):
    """``tests/test_service.py::test_reload_grace_timer_does_not_block_
    close``: four concurrent ``maybe_reload`` calls make exactly one swap,
    the old dispatcher's stop is scheduled, the new engine is warm, and
    ``close`` does not wait out a 30 s grace."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _biased(-10.0))
    pcfg, _ = _cfgs(uri, tmp_path, batch_window_ms=5.0, max_batch=2,
                    reload_grace_s=30.0)
    server, service = grpc_service.build_server(pcfg, device="cpu")
    rgb, depth = _frames(1)[0]
    try:
        service.warmup(W, H)
        old = service.dispatcher
        _register(uri, _biased(10.0))
        swaps = []
        threads = [threading.Thread(
            target=lambda: swaps.append(service.maybe_reload()))
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sum(swaps) == 1 and len(swaps) == 4
        assert service._grace_stops
        assert _submit_coverage(service.dispatcher, rgb, depth) > 99.0
    finally:
        server.stop(grace=None)
        t0 = time.perf_counter()
        service.close()
        closed_in = time.perf_counter() - t0
    assert closed_in < 10.0, closed_in
    assert service._grace_stops == []
    with pytest.raises(RuntimeError, match="dispatcher stopped"):
        old.submit(rgb, depth, _k(), 0.001)


def test_reloader_does_not_touch_global_tracking(tmp_path):
    """``tests/test_service.py::test_reloader_does_not_touch_global_
    tracking``: the poller resolves and loads through a store scoped to
    the server's URI while the process-global URI points elsewhere."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _biased(-10.0))
    pcfg, _ = _cfgs(uri, tmp_path)
    pcfg = dataclasses.replace(pcfg, reload_poll_s=0.05)
    prev = tracking.get_tracking_uri()
    server, service = grpc_service.build_server(pcfg, device="cpu")
    try:
        v2 = _register(uri, _biased(10.0))
        elsewhere = f"file:{tmp_path}/unrelated_mlruns"
        tracking.set_tracking_uri(elsewhere)
        deadline = time.time() + 60.0
        while service.current_version != v2 and time.time() < deadline:
            assert tracking.get_tracking_uri() == elsewhere
            time.sleep(0.05)
        assert service.current_version == v2
        assert tracking.get_tracking_uri() == elsewhere
    finally:
        server.stop(grace=None)
        service.close()
        tracking.set_tracking_uri(prev)


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_old_generation_is_unreachable_after_its_grace(batched, tmp_path):
    """Once the grace period has passed (and no frame is in flight),
    nothing holds the swapped-out generation: its forward, analyzers and
    dispatcher go by reference count alone, with the garbage collector
    off (a reference cycle would keep a dead generation's graphs and
    memory until some later collection), so its memory can be reused."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _biased(-10.0))
    fields = dict(batch_window_ms=5.0, max_batch=2) if batched else {}
    pcfg, _ = _cfgs(uri, tmp_path, reload_grace_s=0.05, **fields)
    service = tserver.build_service(pcfg, warmup_shape=(W, H), device="cpu")
    try:
        refs = [weakref.ref(x) for x in (
            service._engine.forward, service.analyze, service.analyze_coef,
            *([service.dispatcher] if batched else []))]
        _register(uri, _biased(10.0))
        gc.collect()
        gc.disable()
        try:
            assert service.maybe_reload()
            deadline = time.time() + 30
            while not all(r() is None for r in refs):
                assert time.time() < deadline, [r() for r in refs]
                time.sleep(0.05)
        finally:
            gc.enable()
        assert service._grace_stops == []
    finally:
        service.close()


def test_dead_cache_graphs_go_and_their_memory_is_released_once():
    """A graph cache's finalizer destroys its graphs at once and counts
    the death; the reload poller's ``release_dead_pools`` then empties
    the allocator's cache once for the deaths since its last call."""
    from robotic_discovery_platform_tpu_torch.ops import graphs

    graphs.release_dead_pools()  # deaths of earlier tests
    assert not graphs.release_dead_pools()
    held = {"key": ("static inputs", "capture")}
    graphs._cache_died(held)
    assert held == {}
    assert graphs.release_dead_pools()
    assert not graphs.release_dead_pools()


def test_int8_reload_applies_the_tier_to_the_new_version(tmp_path):
    """At ``precision="int8"`` the reloaded generation is version 2
    transformed again (``ops/quant.apply_precision``): its untransformed
    net is version 2's, and its forward computes exactly what a fold of
    ``apply_precision(version 2, "int8")`` computes. The reload does not
    run the parity gate again (the JAX reload does not either)."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _variables(0))
    pcfg, _ = _cfgs(uri, tmp_path, precision="int8")
    service = tserver.build_service(pcfg, device="cpu")
    try:
        v2 = _register(uri, _variables(1))
        assert service.maybe_reload() and service.current_version == v2
        _, net = tracking.load_model(f"models:/{NAME}/{v2}",
                                     tracking.store_for(uri), device="cpu")
        eng = service._engine
        for key, value in net.state_dict().items():
            assert torch.equal(eng.pristine.state_dict()[key], value), key
        want = FoldedUNet(quant.apply_precision(net, "int8")[0],
                          device="cpu")
        x = torch.from_numpy(np.random.default_rng(0).random(
            (1, SIZE, SIZE, 3), np.float32))
        with torch.no_grad():
            assert torch.equal(eng.forward(x), want(x))
        assert service.parity is None  # no gate ran (no warm-up)
    finally:
        service.close()


# -- readiness, drain and the health service -----------------------------------


def test_health_servicer_transitions():
    """``tests/test_resilience.py::test_health_servicer_unit``, plus the
    RPCs in process: Check answers per service, NOT_FOUND for an unknown
    one; Watch pushes the current status and then each change."""
    from robotic_discovery_platform_tpu_torch.serving.proto import health_pb2

    h = health.HealthServicer()
    assert h.get("") == health.NOT_SERVING
    h.set("svc", health.NOT_SERVING)
    h.set_all(health.SERVING)
    assert h.get("") == health.SERVING and h.get("svc") == health.SERVING
    assert h.get("never-registered") is None

    class Context:
        def __init__(self):
            self.active = True

        def is_active(self):
            return self.active

        def abort(self, code, details):
            raise RuntimeError(code)

    ctx = Context()
    req = health_pb2.HealthCheckRequest
    assert h.Check(req(service="svc"), ctx).status == health.SERVING
    with pytest.raises(RuntimeError) as err:
        h.Check(req(service="nope"), ctx)
    assert err.value.args[0] == grpc.StatusCode.NOT_FOUND
    watch = h.Watch(req(service="svc"), ctx)
    assert next(watch).status == health.SERVING
    threading.Timer(0.05, lambda: h.set_all(health.NOT_SERVING)).start()
    assert next(watch).status == health.NOT_SERVING
    ctx.active = False
    h.set("svc", health.SERVING)
    assert list(watch) == []


def _small_registry(tmp_path) -> str:
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, _biased(-10.0))
    return uri


def test_health_endpoint_and_drain_flip(tmp_path):
    """``tests/test_resilience.py::test_health_endpoint_and_drain_flip``
    over a real gRPC channel, and a drain that waits for the stream in
    flight: readiness up after build, NOT_FOUND for an unknown service;
    drain flips readiness down, refuses a new stream with UNAVAILABLE,
    and returns True only once the open stream ends."""
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        health_pb2,
        vision_grpc,
        vision_pb2,
    )

    pcfg, _ = _cfgs(_small_registry(tmp_path), tmp_path)
    server, service = grpc_service.build_server(pcfg, device="cpu")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{service.bound_port}")
    rgb, depth = _frames(1)[0]
    try:
        stub = health.HealthStub(channel)
        req = health_pb2.HealthCheckRequest
        assert stub.Check(req()).status == health.SERVING
        assert stub.Check(req(service=tserver.VISION_SERVICE)).status == (
            health.SERVING)
        with pytest.raises(grpc.RpcError) as err:
            stub.Check(req(service="no.such.Service"))
        assert err.value.code() == grpc.StatusCode.NOT_FOUND

        q: queue.Queue = queue.Queue()

        def held():
            while (item := q.get()) is not None:
                yield item

        live = service.analyze_stream(held())
        q.put(ingest.raw_request(rgb, depth))
        assert not next(live).status.startswith("ERROR")
        assert service.active_streams == 1
        drained = {}
        drainer = threading.Thread(target=lambda: drained.setdefault(
            "ok", service.drain(timeout_s=30.0)))
        drainer.start()
        time.sleep(0.3)
        assert drainer.is_alive() and service.is_draining
        assert stub.Check(req()).status == health.NOT_SERVING
        pb = vision_pb2.AnalysisRequest(
            color_image=vision_pb2.Image(data=rgb.tobytes(), width=W,
                                         height=H, format=1),
            depth_image=vision_pb2.Image(
                data=depth.astype("<u2").tobytes(), width=W, height=H,
                format=1))
        with pytest.raises(grpc.RpcError) as err:
            list(vision_grpc.VisionAnalysisServiceStub(
                channel).AnalyzeActuatorPerformance(iter([pb])))
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        q.put(None)
        assert list(live) == []
        drainer.join(timeout=30)
        assert drained == {"ok": True} and service.active_streams == 0
        assert service.drain(timeout_s=0.0) is True  # idempotent
    finally:
        channel.close()
        server.stop(grace=None)
        service.close()


def test_drain_times_out_with_a_stream_left(tmp_path):
    pcfg, _ = _cfgs(_small_registry(tmp_path), tmp_path)
    service = tserver.build_service(pcfg, device="cpu")
    rgb, depth = _frames(1)[0]
    try:
        live = service.analyze_stream(iter([ingest.raw_request(rgb, depth)]
                                           * 2))
        next(live)
        assert service.drain(timeout_s=0.1) is False
        assert list(live) and service.drain(timeout_s=0.1) is True
        with pytest.raises(tserver.StreamRefusedError):
            next(service.analyze_stream(iter([])))
    finally:
        service.close()


def test_readiness_flips_only_after_warmup(tmp_path):
    """``tests/test_resilience.py::test_readiness_flips_only_after_
    warmup``: NOT_SERVING until the warm-up ends, journaled."""
    pcfg, _ = _cfgs(_small_registry(tmp_path), tmp_path)
    cursor = journal.JOURNAL.snapshot()["next_cursor"]
    service = tserver.build_service(pcfg, device="cpu")
    try:
        assert service.health.get("") == health.NOT_SERVING
        assert service.health.get(tserver.VISION_SERVICE) == (
            health.NOT_SERVING)
        service.warmup(W, H)
        assert service.health.get("") == health.SERVING
        service.drain(timeout_s=1.0)
        events = [(e.kind, e.attrs) for e in
                  journal.JOURNAL.events_since(cursor)]
        assert ("server.ready", {"version": "1"}) in events
        assert ("server.drain", {"streams": "0"}) in events
    finally:
        service.close()


def test_serve_drains_on_interrupt(tmp_path, monkeypatch):
    """``python -m ...serving.server`` (``grpc_service.main``) on a
    KeyboardInterrupt: readiness down, the gRPC server stopped, the
    servicer closed; ``--device`` reaches the servicer."""
    uri = _small_registry(tmp_path)
    made = {}
    build = grpc_service.build_server

    def build_and_interrupt(*args, **kwargs):
        server, service = build(*args, **kwargs)
        made.update(server=server, service=service)

        def interrupt(timeout=None):
            raise KeyboardInterrupt

        monkeypatch.setattr(server, "wait_for_termination", interrupt)
        return server, service

    monkeypatch.setattr(grpc_service, "build_server", build_and_interrupt)
    t0 = time.perf_counter()
    grpc_service.main(["--device", "cpu", "--server.address", "localhost:0",
                       "--server.tracking_uri", uri,
                       "--server.model_img_size", str(SIZE),
                       "--server.reload_poll_s", "0",
                       "--server.metrics_csv", str(tmp_path / "m.csv"),
                       "--server.calibration_path",
                       str(tmp_path / "none.npz")])
    assert time.perf_counter() - t0 < 120
    service = made["service"]
    assert service.device == torch.device("cpu")
    assert service.health.get("") == health.NOT_SERVING
    assert service.is_draining and service._closed
    with pytest.raises(tserver.StreamRefusedError):
        next(service.analyze_stream(iter([])))


def test_server_config_gains_the_jax_fields():
    """The nine fields this slice serves, with the JAX package's names
    and defaults; ``from_dict`` takes them and still refuses unknown
    keys."""
    fields = ("reload_poll_s", "reload_grace_s", "drain_grace_s",
              "registry_breaker_failures", "registry_breaker_reset_s",
              "metrics_port", "slo_ms", "slo_budget", "slo_window")
    port, jax_ = config.ServerConfig(), jconfig.ServerConfig()
    assert {f: getattr(port, f) for f in fields} == {
        f: getattr(jax_, f) for f in fields}
    assert ({f: getattr(port, f) for f in fields}
            == {"reload_poll_s": 10.0, "reload_grace_s": 10.0,
                "drain_grace_s": 5.0, "registry_breaker_failures": 3,
                "registry_breaker_reset_s": 60.0, "metrics_port": 0,
                "slo_ms": 0.0, "slo_budget": 0.01, "slo_window": 512})
    names = {f.name for f in dataclasses.fields(config.ServerConfig)}
    assert names <= {f.name for f in dataclasses.fields(jconfig.ServerConfig)}
    made = config.from_dict(config.ServerConfig, {f: getattr(jax_, f)
                                                  for f in fields})
    assert made == port
    # the drift fields came with the drift monitor (test_torch_port_drift.
    # py) and the fleet's with the fleet (test_torch_port_fleet.py); the
    # multi-device router's keys are refused naming their item, and a key
    # no package knows as unknown
    assert config.from_dict(config.ServerConfig, {"drift_enabled": True}) == (
        port)
    assert config.from_dict(config.ServerConfig, {"fleet_replicas": ""}) == (
        port)
    with pytest.raises(NotImplementedError, match="item 14"):
        config.from_dict(config.ServerConfig, {"dispatch_mode": "shared"})
    with pytest.raises(ValueError, match="unknown config keys"):
        config.from_dict(config.ServerConfig, {"no_such_field": ""})


def test_frames_feed_the_instruments(tmp_path, monkeypatch):
    """A stream's frames move the JAX package's frame instruments: frames
    by status, the four stage latencies, end-to-end latency, the SLO
    tracker, in-flight streams back at 0; an error status carries the
    stream's trace ID."""
    monkeypatch.delenv("RDP_SLO_MS", raising=False)
    pcfg, _ = _cfgs(_small_registry(tmp_path), tmp_path, slo_ms=1e6)
    service = tserver.build_service(pcfg, device="cpu")
    rgb, depth = _frames(1)[0]
    bad = ingest.raw_request(rgb, depth)
    bad.color_image.data = bad.color_image.data[:-3]

    def counts():
        return ([obs.FRAMES.labels(status=s, model="seg").value
                 for s in ("ok", "degraded", "error")],
                [obs.STAGE_LATENCY.labels(stage=s).count for s in
                 ("decode", "device", "encode", "total")],
                obs.FRAME_LATENCY_SUMMARY.count)

    try:
        before = counts()
        out = list(service.analyze_stream(iter(
            [ingest.raw_request(rgb, depth)] * 3 + [bad])))
        after = counts()
        good = sum(not r.status.startswith("ERROR") for r in out)
        assert good == 3
        assert sum(after[0][:2]) - sum(before[0][:2]) == 3
        assert after[0][2] - before[0][2] == 1
        assert [a - b for a, b in zip(after[1], before[1])] == [4, 3, 3, 4]
        assert after[2] - before[2] == 4
        assert service.slo.observed_total == 4
        assert service.slo.violations_total == 1  # the error frame
        assert obs.INFLIGHT_STREAMS.value == 0
        assert out[3].status.startswith("ERROR: ValueError")
        assert out[3].status.endswith("]") and "[trace=" in out[3].status
        assert "[trace=-]" not in out[3].status
    finally:
        service.close()


@pytest.mark.parametrize("h,w", [(120, 160), (480, 640)])
def test_served_coverage_is_the_jax_servers_to_the_bit(h, w):
    """The coverage a server answers, for every pixel count of a 120x160
    frame and 4097 counts of a 480x640 one: the port's float32 product
    equals the JAX package's jitted ``100 * jnp.mean`` of the 0/1 mask
    bit for bit (found by the reload test above, whose version 2 frames
    differed by one float32 ulp before)."""
    n = h * w
    counts = np.unique(np.linspace(0, n, min(n + 1, 4097)).astype(np.int64))
    if n <= 20000:
        counts = np.arange(n + 1)
    jitted = jax.jit(lambda m: 100.0 * jnp.mean(m, axis=(1, 2)))
    want = []
    for chunk in np.array_split(counts, max(1, len(counts) // 512)):
        masks = (np.arange(n)[None] < chunk[:, None]).astype(np.float32)
        want.append(np.asarray(jitted(masks.reshape(-1, h, w))))
    got = tpipe.mask_coverage(torch.from_numpy(counts), h, w).numpy()
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_servicer_core_imports_without_grpc():
    """grpc and protobuf are imported only where the wire needs them: the
    servicer, its health registry and the metrics endpoint import and
    run in a process where both are missing."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
        "from robotic_discovery_platform_tpu_torch.serving import health, "
        "server, grpc_service\n"
        "from robotic_discovery_platform_tpu_torch.observability import "
        "exposition\n"
        "h = health.HealthServicer()\n"
        "h.set_all(health.SERVING)\n"
        "assert h.get('') == health.SERVING\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
