"""The port's model zoo (serving/zoo.py, models/variants.py and the zoo in
serving/server.py and serving/batching.py) against the JAX package's, on
the CPU.

Tolerances, fixed before measuring:
- the catalog, the variant configs, the anomaly score, the estimator keys,
  the placer's correlations and placements: identical (exact floats);
- a zoo server's answers against the JAX zoo server's, per model (the
  tolerances of tests/test_torch_port_serving.py): statuses, coverage and
  the packed-bits masks identical; curvature rtol 1e-3;
- a zoo server's default path against the port's single-model server, and
  each extra against a servicer serving that model alone: bit for bit.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models import variants as jvariants
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.serving import admission as jadmission
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.serving import zoo as jzoo
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import variants as tvariants
from robotic_discovery_platform_tpu_torch.observability import exposition
from robotic_discovery_platform_tpu_torch.resilience import configure_faults
from robotic_discovery_platform_tpu_torch.serving import admission
from robotic_discovery_platform_tpu_torch.serving import egress, ingest
from robotic_discovery_platform_tpu_torch.serving import server as tserver
from robotic_discovery_platform_tpu_torch.serving import zoo as tzoo
from robotic_discovery_platform_tpu_torch.utils import config

H, W, SIZE, BASE = 120, 160, 64, 8
NAME = "Actuator-Segmenter"


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


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    configure_faults(None)


# -- the catalog --------------------------------------------------------------


@pytest.mark.parametrize("lib", [jvariants, tvariants], ids=["jax", "port"])
def test_resolve_zoo_models_default_and_order(lib, monkeypatch):
    monkeypatch.delenv("RDP_ZOO_MODELS", raising=False)
    assert lib.resolve_zoo_models("") == ("seg",)
    assert lib.resolve_zoo_models("aux,seg") == ("seg", "aux")
    assert lib.resolve_zoo_models("multi, aux") == ("seg", "multi", "aux")
    with pytest.raises(ValueError, match="unknown zoo model"):
        lib.resolve_zoo_models("seg,bogus")
    monkeypatch.setenv("RDP_ZOO_MODELS", "seg,aux")
    assert lib.resolve_zoo_models("") == ("seg", "aux")
    assert lib.resolve_zoo_models("multi") == ("seg", "aux")


def test_catalog_and_variant_configs_match_jax():
    assert tvariants.DEFAULT_MODEL == jvariants.DEFAULT_MODEL
    assert tvariants.HEADS == jvariants.HEADS
    assert set(tvariants.VARIANTS) == set(jvariants.VARIANTS)
    for name, tv in tvariants.VARIANTS.items():
        jv = jvariants.VARIANTS[name]
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert (tvariants.registered_name(tv, NAME)
                == jvariants.registered_name(jv, NAME))
        for base in (64, 8, 4):
            t = tv.model_config(config.ModelConfig(base_features=base))
            j = jv.model_config(jconfig.ModelConfig(base_features=base))
            assert (t.num_classes, t.base_features, t.compute_dtype,
                    t.norm) == (j.num_classes, j.base_features,
                                j.compute_dtype, j.norm)
    # the published widths: aux at base 16, multi's head 64 -> 4
    aux = tvariants.build_variant_model(tvariants.VARIANTS["aux"],
                                        config.ModelConfig())
    assert aux.cfg.base_features == 16
    assert tuple(aux.DoubleConv_0.Conv_1.kernel.shape) == (3, 3, 16, 16)
    multi = tvariants.build_variant_model(tvariants.VARIANTS["multi"],
                                          config.ModelConfig())
    assert tuple(multi.Conv_0.kernel.shape) == (1, 1, 64, 4)


@pytest.mark.parametrize("margin", [0.5, 0.0, 0.25, 0.7, -1.0, 0.123])
def test_anomaly_score_matches_jax(margin):
    assert tvariants.anomaly_score(margin) == jvariants.anomaly_score(margin)


@pytest.mark.parametrize("lib", [jzoo, tzoo], ids=["jax", "port"])
def test_resolve_zoo_placement(lib, monkeypatch):
    monkeypatch.delenv("RDP_ZOO_PLACEMENT", raising=False)
    assert lib.resolve_zoo_placement("shared") == "shared"
    with pytest.raises(ValueError, match="unknown zoo placement"):
        lib.resolve_zoo_placement("bogus")
    monkeypatch.setenv("RDP_ZOO_PLACEMENT", "dedicated")
    assert lib.resolve_zoo_placement("shared") == "dedicated"


def test_estimator_keys_match_jax():
    """The keyed ServiceTimeEstimator gives each model its own estimate in
    both packages: the same observations, the same answers."""
    rides = [(0.5, ("seg", 4)), (0.4, ("seg", 1)), (0.001, ("aux", 1)),
             (0.3, None), (-1.0, None), (0.6, ("seg", 1))]
    for window in (8, 2):
        t = admission.ServiceTimeEstimator(window=window)
        j = jadmission.ServiceTimeEstimator(window=window)
        for v, key in rides:
            t.observe(v, key=key) if key else t.observe(v)
            j.observe(v, key=key) if key else j.observe(v)
            for m in ("seg", "aux", "multi", ""):
                assert t.s_for(m) == j.s_for(m)
            assert t.s == j.s and t.observations == j.observations


# -- the placer ---------------------------------------------------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


PATTERNS = {
    "anti": {"seg": lambda t: 20 if (t // 10) % 2 == 0 else 1,
             "aux": lambda t: 1 if (t // 10) % 2 == 0 else 20},
    "sync": {"seg": lambda t: 20 if (t // 10) % 2 == 0 else 1,
             "aux": lambda t: 20 if (t // 10) % 2 == 0 else 1},
    "three": {"seg": lambda t: 10 + (t % 7),
              "multi": lambda t: 30 if (t // 5) % 2 else 2,
              "aux": lambda t: 2 if (t // 5) % 2 else 30},
}


def _placers(models, chips, mode, rebalance_s):
    out = []
    for lib in (jzoo, tzoo):
        clock = FakeClock()
        out.append((lib.ZooPlacer(models, chips=chips, mode=mode,
                                  rebalance_s=rebalance_s, clock=clock),
                    clock))
    return out


@pytest.mark.parametrize("rebalance_s", [0.0, 5.0])
@pytest.mark.parametrize("chips", [1, 2, 4])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("mode", ["shared", "dedicated"])
def test_placer_decides_as_jax(pattern, chips, mode, rebalance_s):
    """The same arrival series into the JAX and the port's placer: the
    same correlations, placements, rates and snapshot at every step (with
    and without placements made on arrival), one chip (the port's card)
    and several."""
    rates = PATTERNS[pattern]
    models = tuple(rates)
    pair = _placers(models, chips, mode, rebalance_s)
    for _ in range(40):
        for placer, clock in pair:
            for model, fn in rates.items():
                for _ in range(int(fn(clock.t))):
                    placer.record_arrival(model)
            clock.t += 1.0
        (jp, _), (tp, _) = pair
        for m in models + ("never-heard-of-it",):
            assert tp.chips_for(m) == jp.chips_for(m)
    (jp, _), (tp, _) = pair
    assert tp.correlations() == jp.correlations()
    assert tp.rebalance() == jp.rebalance()
    assert tp.rates() == jp.rates()
    assert tp.snapshot() == jp.snapshot()
    assert tp.rebalances == jp.rebalances
    if chips == 1:
        assert all(tp.chips_for(m) == (0,) for m in models)
    if pattern == "anti" and chips == 4 and mode == "shared":
        assert tp.correlations()[("seg", "aux")] < -0.5
        assert tp.rebalance()["aux"] == (0, 1, 2, 3)
    if pattern == "sync" and chips == 4 and mode == "shared":
        assert any(len(c) == 2 for c in tp.rebalance().values())


@pytest.mark.parametrize("lib", [jzoo, tzoo], ids=["jax", "port"])
def test_rate_window_counts_per_interval(lib):
    clock = FakeClock()
    win = lib.RateWindow(interval_s=1.0, window=10, clock=clock)
    for _ in range(30):
        win.record()
        clock.t += 0.2
    assert win.mean_rate() == pytest.approx(5.0, rel=0.25)
    clock.t += 1000.0
    assert win.mean_rate() == 0.0


@pytest.mark.parametrize("n", [4, 7, 12])
def test_correlation_matches_jax(n):
    rng = np.random.default_rng(n)
    a, b = list(rng.uniform(0, 9, n)), list(rng.uniform(0, 9, n + 2))
    assert tzoo.correlation(a, b) == jzoo.correlation(a, b)
    assert tzoo.correlation(a, [1.0] * n) == jzoo.correlation(a, [1.0] * n)


# -- zoo servers --------------------------------------------------------------


def _variables(mcfg, seed: int) -> dict:
    """JAX-initialized variables with BatchNorm statistics from a numpy
    seed and each class's head bias at frame 0's median logit, so every
    class's mask is structured."""
    model = build_unet(mcfg)
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
    logits = np.asarray(model.apply(variables, x))
    median = np.median(logits.reshape(-1, logits.shape[-1]), axis=0)
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return variables


def _register_zoo(uri: str, models=("seg", "multi", "aux")) -> None:
    """Each variant of ``models`` as version 1 of its registry entry under
    ``staging``, written by the JAX package's tracking."""
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    base = jconfig.ModelConfig(base_features=BASE, compute_dtype="float32")
    try:
        jtracking.set_experiment("Actuator Segmentation")
        for i, name in enumerate(models):
            variant = jvariants.VARIANTS[name]
            mcfg = variant.model_config(base)
            reg = jvariants.registered_name(variant, NAME)
            with jtracking.start_run():
                version = jtracking.log_model(_variables(mcfg, 10 + i), mcfg,
                                              registered_model_name=reg)
            jtracking.Client().set_registered_model_alias(reg, "staging",
                                                          version)
    finally:
        jtracking.set_tracking_uri(prev)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo-registry")
    uri = f"file:{root / 'mlruns'}"
    _register_zoo(uri)
    return uri, root


def _frames(n: int = 3):
    rng = np.random.default_rng(100)
    return [render_scene(rng, H, W)[::2] for _ in range(n)]  # (rgb, depth)


def _cfg(uri, root, name: str, **fields) -> config.ServerConfig:
    return config.ServerConfig(
        address="localhost:0", tracking_uri=uri, model_img_size=SIZE,
        calibration_path=str(root / "none.npz"), reload_poll_s=0.0,
        metrics_csv=str(root / f"{name}.csv"), **fields)


def _port_answers(service, frames, model="", mask_format=1):
    out = []
    for resp in service.analyze_stream(iter(
            [ingest.raw_request(rgb, depth, mask_format=mask_format,
                                model=model) for rgb, depth in frames])):
        out.append((resp.status, resp.mask, resp.mask_coverage,
                    resp.mean_curvature, resp.max_curvature))
    return out


def _reference_keeps_every_edge_point(payload: bytes, depth) -> bool:
    """False on frames where the JAX package drops its last edge point
    from the spline fit, the documented divergence
    (tests/test_torch_port_pipeline.py::test_chord_parameters_clip_at_one;
    tests/test_torch_port_serving.py compares curvature only where this
    holds too)."""
    mask = egress.decode_mask_wire(payload)
    k = ingest.default_intrinsics(W, H).astype(np.float32)
    maps = jgeom.deproject(jnp.asarray(mask), jnp.asarray(depth), k[0, 0],
                           k[1, 1], k[0, 2], k[1, 2], jnp.float32(0.001))
    e = jgeom._edge_points(*maps, jconfig.GeometryConfig(kernel_impl="xla"))
    pts, wts = jgeom._sort_by_x(e[0], e[1])
    return float(np.max(np.asarray(
        jbspline.chord_length_params(pts, wts)))) <= 1.0


def _statuses_ok(answers):
    return all(a[0].startswith(("OK", "DEGRADED")) for a in answers)


def test_zoo_server_answers_as_the_jax_zoo_server(registry):
    """Each model's frames through the JAX zoo servicer's frame path and
    through the port's zoo servicer: statuses, anomaly scores, coverage
    and packed masks identical, curvature within rtol 1e-3; an unknown
    model is that frame's error in both, and the stream goes on."""
    uri, root = registry
    jcfg = jconfig.ServerConfig(
        address="localhost:0", tracking_uri=uri, model_img_size=SIZE,
        calibration_path=str(root / "none.npz"), reload_poll_s=0.0,
        metrics_csv=str(root / "j.csv"), zoo_models="multi,aux")
    prev = jtracking.get_tracking_uri()
    try:
        jmodel, jvars, version = jserver.resolve_serving_model(jcfg)
        jservice = jserver.VisionAnalysisService(
            jmodel, jvars, None, 0.001, jcfg, version=version)
    finally:
        jtracking.set_tracking_uri(prev)
    service = tserver.build_service(_cfg(uri, root, "p", zoo_models="multi,aux"),
                                    device="cpu")
    try:
        assert service.zoo.names() == jservice.zoo.names() == (
            "seg", "multi", "aux")
        frames = _frames()
        compared = 0
        for model in ("", "seg", "multi", "aux"):
            want = []
            for rgb, depth in frames:
                res = jservice._analyze_frame(rgb, depth, mask_format=1,
                                              model=model)
                status = "OK" if res.valid else tserver.STATUS_DEGRADED
                if res.anomaly is not None:
                    status += f" anomaly={res.anomaly:.4f}"
                want.append((status, res.mask_png,
                             float(np.float32(res.coverage)), res.mean_k,
                             res.max_k))
            got = _port_answers(service, frames, model)
            assert _statuses_ok(got)
            assert ("anomaly=" in got[0][0]) == (model == "aux")
            for g, w, (_, depth) in zip(got, want, frames, strict=True):
                assert g[0] == w[0]
                assert g[1] == w[1]  # packed bits, byte for byte
                assert g[2] == w[2]
                if (g[0].startswith("OK")
                        and _reference_keeps_every_edge_point(g[1], depth)):
                    np.testing.assert_allclose(g[3:], w[3:], rtol=1e-3,
                                               atol=0.0)
                    compared += 1
        assert compared >= 4
        with pytest.raises(jzoo.UnknownModelError):
            jservice._analyze_frame(*frames[0], model="nope")
        got = list(service.analyze_stream(iter([
            ingest.raw_request(*frames[0], model="nope"),
            ingest.raw_request(*frames[0])])))
        assert got[0].status.startswith("ERROR: UnknownModel")
        assert got[1].status.startswith(("OK", "DEGRADED"))
    finally:
        service.close()
        jservice.close()


def _single(uri, root, name, model, **fields):
    """A servicer serving zoo model ``model``'s registry entry alone, as
    its default model."""
    reg = tvariants.registered_name(tvariants.VARIANTS[model], NAME)
    return tserver.build_service(
        _cfg(uri, root, name, model_name=reg, **fields), device="cpu")


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_default_path_and_extras_equal_single_model_servers(batched,
                                                            registry):
    """A zoo servicer's "" and "seg" frames equal the port's single-model
    servicer bit for bit (the JAX test_zoo_default_path_bitwise_parity),
    and each extra's equal a servicer of that model alone; on the batched
    path no dispatch mixes models."""
    uri, root = registry
    fields = (dict(batch_window_ms=2.0, max_batch=4,
                   max_inflight_dispatches=1) if batched else {})
    zoo = tserver.build_service(
        _cfg(uri, root, "z", zoo_models="multi,aux", **fields), device="cpu")
    servers = {m: _single(uri, root, m, m, **fields)
               for m in ("seg", "multi", "aux")}
    try:
        if batched:
            zoo.warmup(W, H)
        frames = _frames()
        for fmt in (0, 1):
            legacy = _port_answers(servers["seg"], frames, mask_format=fmt)
            assert _port_answers(zoo, frames, mask_format=fmt) == legacy
            assert _port_answers(zoo, frames, "seg", fmt) == legacy
            for m in ("multi", "aux"):
                got = _port_answers(zoo, frames, m, fmt)
                alone = _port_answers(servers[m], frames, mask_format=fmt)
                if m == "aux":  # the status adds the anomaly score only
                    got = [(g[0].split(" anomaly=")[0],) + g[1:]
                           for g in got]
                assert got == alone
        if batched:
            # mixed models under concurrent streams: a dispatch holds one
            # model's frames, and every answer is its model's
            want = {m: _port_answers(zoo, frames, m) for m in
                    ("", "multi", "aux")}
            seen = []
            real = zoo.dispatcher._analyze_for

            def spy(model):
                seen.append(model)
                return real(model)

            zoo.dispatcher._analyze_for = spy
            out, errs = {}, []

            def stream(i, m):
                try:
                    out[i] = (m, _port_answers(zoo, frames, m))
                except Exception as exc:  # noqa: BLE001 - reported below
                    errs.append(exc)

            threads = [threading.Thread(target=stream, args=(i, m))
                       for i, m in enumerate(["", "multi", "aux"] * 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errs
            for m, answers in out.values():
                assert answers == want[m]
            assert set(seen) == {"", "multi", "aux"}
    finally:
        zoo.close()
        for s in servers.values():
            s.close()


@pytest.fixture(scope="module")
def zoo_server(registry):
    """One batched seg+aux zoo servicer with an SLO, warmed."""
    uri, root = registry
    service = tserver.build_service(
        _cfg(uri, root, "zs", zoo_models="aux", batch_window_ms=2.0,
             max_batch=4, slo_ms=30000.0), device="cpu")
    service.warmup(W, H)
    yield service
    service.close()


def test_capped_zoo_warmup(zoo_server):
    """The default model captures every bucket at warm-up; an extra
    captures its one-frame bucket only (the rest at first use)."""
    warmed = zoo_server.dispatcher.warmed
    assert {("", 0, 1), ("", 0, 2), ("", 0, 4)} <= warmed
    assert ("aux", 0, 1) in warmed
    assert ("aux", 0, 4) not in warmed
    debug = zoo_server.zoo_debug()
    assert debug["enabled"] is True
    assert debug["models"]["aux"]["head"] == "anomaly"
    assert debug["models"]["aux"]["registered_name"] == "Actuator-AuxHead"
    assert debug["placement"]["mode"] == "shared"
    assert debug["placement"]["chips"] == 1


def test_eager_warm_negative_captures_every_bucket(registry):
    uri, root = registry
    service = tserver.build_service(
        _cfg(uri, root, "full", zoo_models="aux", batch_window_ms=2.0,
             max_batch=4, zoo_eager_warm=-1), device="cpu")
    try:
        service.warmup(W, H)
        assert {("aux", 0, b) for b in (1, 2, 4)} <= service.dispatcher.warmed
    finally:
        service.close()


def test_model_fault_isolation(zoo_server):
    """A fault at one model's dispatch site fails that model's frames
    only; the model serves again once the fault is gone."""
    frames = _frames(2)
    configure_faults("serving.model.aux.dispatch:exc:-1")
    try:
        seg = _port_answers(zoo_server, frames)
        aux = _port_answers(zoo_server, frames, "aux")
    finally:
        configure_faults(None)
    assert _statuses_ok(seg)
    assert all(a[0].startswith("ERROR") for a in aux)
    assert _statuses_ok(_port_answers(zoo_server, frames[:1], "aux"))


def test_zoo_metrics_labels(zoo_server):
    """Frames by (status, model), each model's burn beside the aggregate,
    the roster size, per-model dispatches and arrival rates; the per-model
    frame counts sum to the frames answered."""
    before = zoo_server.zoo_debug()["models"]
    _port_answers(zoo_server, _frames(2), "aux")
    _port_answers(zoo_server, _frames(1))
    text = exposition.render()
    assert 'rdp_frames_total{status="ok",model="aux"}' in text or \
        'rdp_frames_total{status="degraded",model="aux"}' in text
    assert 'rdp_slo_error_budget_burn{objective="e2e",model=""}' in text
    assert 'rdp_slo_error_budget_burn{objective="e2e",model="seg"}' in text
    assert 'rdp_slo_error_budget_burn{objective="e2e",model="aux"}' in text
    assert "rdp_zoo_models 2" in text
    assert 'rdp_model_dispatches_total{model="aux"}' in text
    assert 'rdp_model_arrival_rate{model="seg"}' in text
    after = zoo_server.zoo_debug()["models"]
    assert after["aux"]["frames"] - before["aux"]["frames"] == 2
    assert after["seg"]["frames"] - before["seg"]["frames"] == 1
    est = zoo_server.dispatcher.service_estimate
    assert est.s_for("") > 0.0 and est.s_for("aux") > 0.0
    assert est.s_for("multi") == 0.0


def test_missing_extra_is_left_out(tmp_path):
    """An extra whose registry entry is missing is left out; the server
    serves what exists."""
    uri = f"file:{tmp_path / 'mlruns'}"
    _register_zoo(uri, models=("seg",))
    service = tserver.build_service(
        _cfg(uri, tmp_path, "m", zoo_models="aux"), device="cpu")
    try:
        assert service.zoo.names() == ("seg",)
        assert service.placer is not None
        got = list(service.analyze_stream(iter([
            ingest.raw_request(*_frames(1)[0], model="aux")])))
        assert got[0].status.startswith("ERROR: UnknownModel")
    finally:
        service.close()


def test_each_zoo_model_round_trips_through_grpc(registry):
    """A request for each zoo model, made by the port's client
    (``encode_request(model=...)``), through the port's gRPC server: the
    answer the servicer gives in process."""
    grpc = pytest.importorskip("grpc")
    from robotic_discovery_platform_tpu_torch.serving import (
        client,
        grpc_service,
    )
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
    )

    uri, root = registry
    server, service = grpc_service.build_server(
        _cfg(uri, root, "g", zoo_models="multi,aux"), device="cpu")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{service.bound_port}")
    try:
        stub = vision_grpc.VisionAnalysisServiceStub(channel)
        frames = _frames(2)
        for model in ("", "seg", "multi", "aux", "nope"):
            reqs = [client.encode_request(rgb[..., ::-1], depth, fmt="raw",
                                          model=model, mask_format=1)
                    for rgb, depth in frames]
            got = list(stub.AnalyzeActuatorPerformance(iter(reqs),
                                                       timeout=120))
            if model == "nope":
                assert all(r.status.startswith("ERROR: UnknownModel")
                           for r in got)
                continue
            want = _port_answers(service, frames, model)
            assert [(r.status, r.mask, r.mask_coverage, r.mean_curvature,
                     r.max_curvature) for r in got] == want
    finally:
        channel.close()
        server.stop(grace=None)
        service.close()
