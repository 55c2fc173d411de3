"""The port's reactive SLO controller (serving/controller.py) and its
wiring (the dispatcher's set_* methods in serving/batching.py, rung 3 in
serving/server.py) against the JAX package's, on the CPU.

Every fake-clock sequence of the JAX package's tests/test_controller.py
(the escalation and its symmetric exit, the dead band, AIMD, the bucket
floor, min_samples) runs on the JAX controller over a fake dispatcher and
on the port's controller over the same fake and over the port's real
BatchDispatcher on the CPU: at every tick the action strings, the ladder's
level and the knob values (window, max_inflight, deadline_safety, bucket
floor) must be identical. The mode switch is the multi-device router's
(ROADMAP queue 1 item 14) and is not replayed.

Tolerances, fixed before measuring: none. Actions and knobs are compared
exactly; an idle controller's responses equal the controller-off
server's bit for bit.
"""

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.serving import controller as jcontroller
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import controller
from robotic_discovery_platform_tpu_torch.serving import ingest
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    StreamRefusedError,
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils import config

_DEPTH = np.zeros((8, 8), np.uint16)
_K = np.eye(3, dtype=np.float32)


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


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeDispatcher:
    """The JAX test's fake dispatcher: the knobs and their setters."""

    def __init__(self):
        self.max_inflight = 2
        self._window_ms = 2.0
        self.bucket_floor = 1
        self.deadline_safety = 1.0
        self.recent_batch = 0.0
        self._max_batch = 8
        self._backlog = 0
        self.router = None

    @property
    def window_ms(self):
        return self._window_ms

    def set_window_ms(self, ms):
        self._window_ms = ms

    def set_max_inflight(self, n):
        self.max_inflight = max(1, int(n))

    def set_bucket_floor(self, floor):
        self.bucket_floor = max(1, int(floor))

    def set_deadline_safety(self, factor):
        self.deadline_safety = max(1.0, float(factor))

    def backlog(self):
        return self._backlog


def _real_dispatcher() -> BatchDispatcher:
    d = BatchDispatcher(lambda *a: None, window_ms=2.0, max_batch=8,
                        max_inflight=2, device="cpu",
                        watchdog_interval_s=0.0)
    d._backlog = 0
    d.backlog = lambda: d._backlog  # the backlog the sequence sets
    return d


class Twins:
    """The JAX controller over a fake dispatcher, and the port's over the
    same fake and over the port's real dispatcher, all on one fake clock
    and one burn signal; :meth:`tick` ticks all three and holds their
    actions and knobs equal."""

    def __init__(self, samples=None, refuse=True, **kw):
        kw.setdefault("sustain_s", 1.0)
        kw.setdefault("cooldown_s", 2.0)
        self.clock = FakeClock()
        self.burn = {"v": 0.0}
        self.refusals = {"jax": [], "fake": [], "real": []}
        self.dispatchers = {"jax": FakeDispatcher(), "fake": FakeDispatcher(),
                            "real": _real_dispatcher()}
        self.controllers = {}
        for name, d in self.dispatchers.items():
            lib = jcontroller if name == "jax" else controller
            self.controllers[name] = lib.ReactiveController(
                dispatcher=lambda d=d: d, burn=lambda: self.burn["v"],
                refuse_streams=(self.refusals[name].append if refuse
                                else None),
                samples=samples, clock=self.clock, **kw)

    @property
    def d(self):
        return self.dispatchers["jax"]

    @property
    def c(self):
        return self.controllers["jax"]

    def set(self, **knobs):
        """Set a knob on every dispatcher (``backlog`` or ``max_inflight``)."""
        for d in self.dispatchers.values():
            if "backlog" in knobs:
                d._backlog = knobs["backlog"]
            if "max_inflight" in knobs:
                if isinstance(d, BatchDispatcher):
                    d.set_max_inflight(knobs["max_inflight"])
                else:
                    d.max_inflight = knobs["max_inflight"]

    def tick(self):
        actions = {n: c.tick() for n, c in self.controllers.items()}
        state = {n: (actions[n], self.controllers[n].level,
                     self.controllers[n].actions_total, d.window_ms,
                     d.max_inflight, d.deadline_safety, d.bucket_floor,
                     self.refusals[n])
                 for n, d in self.dispatchers.items()}
        assert state["fake"] == state["jax"]
        assert state["real"] == state["jax"]
        return actions["jax"]

    def close(self):
        self.dispatchers["real"].stop()


@pytest.fixture
def twins():
    made = []

    def make(**kw):
        made.append(Twins(**kw))
        return made[-1]

    yield make
    for t in made:
        t.close()


def test_controller_escalates_the_brownout_ladder_and_exits_symmetrically(
        twins):
    w = twins()
    w.burn["v"] = 5.0
    assert w.tick() is None  # burn high but not yet sustained
    w.clock.advance(1.1)
    assert w.tick() == "window_down"  # rung 1: window + inflight halved
    assert w.c.level == 1 and w.d.window_ms == 1.0 and w.d.max_inflight == 1
    w.clock.advance(0.5)
    assert w.tick() is None  # the cooldown holds the next rung back
    w.clock.advance(2.0)
    assert w.tick() == "admission_tighten"  # rung 2: shed earlier
    assert w.d.deadline_safety == 2.0
    w.clock.advance(0.5)
    assert w.tick() is None
    w.clock.advance(3.0)
    assert w.tick() == "refuse_streams"  # rung 3
    assert w.c.level == 3 and w.refusals["jax"] == [True]
    # the symmetric exit, rung by rung
    w.burn["v"] = 0.1
    w.clock.advance(3.5)
    assert w.tick() is None
    w.clock.advance(1.1)
    assert w.tick() == "accept_streams"
    assert w.refusals["jax"] == [True, False]
    w.clock.advance(0.5)
    assert w.tick() is None
    w.clock.advance(2.0)
    assert w.tick() == "admission_relax" and w.d.deadline_safety == 1.0
    w.clock.advance(0.5)
    assert w.tick() is None
    w.clock.advance(2.0)
    assert w.tick() == "window_up"
    assert w.c.level == 0 and w.d.window_ms == 2.0 and w.d.max_inflight == 2


def test_rung_three_without_a_refusal_hook_holds_rung_two(twins):
    w = twins(refuse=False)
    w.burn["v"] = 5.0
    for _ in range(12):
        w.clock.advance(1.1)
        w.tick()
    assert w.c.level == 2 and w.d.deadline_safety == 3.0


def test_controller_hysteresis_dead_band_and_spikes_do_nothing(twins):
    w = twins()
    w.burn["v"] = 0.7  # inside the dead band
    for _ in range(10):
        w.clock.advance(1.0)
        assert w.tick() is None
    w.burn["v"] = 9.0  # a spike shorter than sustain_s
    assert w.tick() is None
    w.burn["v"] = 0.7
    w.clock.advance(0.5)
    assert w.tick() is None
    assert w.c.level == 0 and w.c.actions_total == 0


def test_controller_aimd_inflight_increase_under_backlog(twins):
    w = twins(inflight_cap=4)
    w.set(backlog=4)
    assert w.tick() is None  # the low-burn timer starts here
    w.clock.advance(1.1)
    assert w.tick() == "inflight_up" and w.d.max_inflight == 3
    w.clock.advance(0.5)
    assert w.tick() is None
    w.clock.advance(2.0)
    assert w.tick() == "inflight_up" and w.d.max_inflight == 4
    w.clock.advance(0.5)
    w.tick()
    w.clock.advance(2.0)
    assert w.tick() != "inflight_up"  # capped at inflight_cap


def test_controller_bucket_floor_follows_backlog(twins):
    w = twins(inflight_cap=8)
    w.set(max_inflight=8, backlog=6)  # at the cap: the floor is reachable
    assert w.tick() is None
    w.clock.advance(1.1)
    assert w.tick() == "floor_up" and w.d.bucket_floor == 2
    w.set(backlog=16)
    for want in (4, 8):
        w.clock.advance(2.1)
        assert w.tick() is None  # the low timer starts again
        w.clock.advance(1.1)
        assert w.tick() == "floor_up" and w.d.bucket_floor == want
    w.clock.advance(2.1)
    w.tick()
    w.clock.advance(1.1)
    assert w.tick() is None  # at max_batch: no further floor
    w.set(backlog=0)  # the low signal has held: the floor comes down
    w.clock.advance(0.5)
    assert w.tick() == "floor_down" and w.d.bucket_floor == 4
    w.clock.advance(0.5)
    assert w.tick() is None
    w.clock.advance(2.0)
    assert w.tick() == "floor_down" and w.d.bucket_floor == 2


def test_controller_min_samples_gates_the_burn_signal(twins):
    samples = {"n": 3}
    w = twins(samples=lambda: samples["n"])
    w.burn["v"] = 50.0
    for _ in range(5):
        w.clock.advance(1.1)
        assert w.tick() is None  # an unfilled window never browns out
    samples["n"] = 100
    w.clock.advance(1.1)
    assert w.tick() is None  # burn must now sustain from scratch
    w.clock.advance(1.1)
    assert w.tick() == "window_down"


@pytest.mark.parametrize("value,configured,want", [
    (None, True, True), (None, False, False), ("1", False, True),
    ("on", False, True), ("off", True, False), ("0", True, False),
])
def test_resolve_controller_enabled_env(monkeypatch, value, configured,
                                        want):
    if value is None:
        monkeypatch.delenv("RDP_CONTROLLER", raising=False)
    else:
        monkeypatch.setenv("RDP_CONTROLLER", value)
    assert controller.resolve_controller_enabled(configured) is want
    assert jcontroller.resolve_controller_enabled(configured) is want


@pytest.mark.parametrize("lib", [jcontroller, controller],
                         ids=["jax", "port"])
def test_controller_validates_thresholds(lib):
    with pytest.raises(ValueError, match="burn_low"):
        lib.ReactiveController(dispatcher=lambda: None, burn=lambda: 0.0,
                               burn_high=0.5, burn_low=1.0)


def test_config_fields_match_jax():
    """The seven controller_* fields: the JAX package's names and
    defaults, taken by from_dict and the flags."""
    from robotic_discovery_platform_tpu.utils import config as jconfig

    names = [f for f in jconfig.ServerConfig.__dataclass_fields__
             if f.startswith("controller_")]
    assert len(names) == 7
    for f in names:
        assert (getattr(config.ServerConfig(), f)
                == getattr(jconfig.ServerConfig(), f)), f
    cfg = config.from_dict(config.ServerConfig, {
        "controller_enabled": True, "controller_interval_s": 0.1})
    assert cfg.controller_enabled and cfg.controller_interval_s == 0.1
    parsed = config.parse_config(["--server.controller_burn_low", "0.25"])
    assert parsed.server.controller_burn_low == 0.25


# -- the dispatcher's knobs ---------------------------------------------------


def test_dispatcher_knobs_hold_jax_semantics():
    """set_max_inflight starts a new window (in-flight dispatches keep
    theirs); the window is read per collect cycle; bucket_for pads to the
    floor, clamped to max_batch and to the buckets captured for the
    model; deadline_safety never drops below 1."""
    d = BatchDispatcher(lambda *a: None, window_ms=2.0, max_batch=8,
                        max_inflight=2, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        old = d._slots
        d.set_max_inflight(2)
        assert d._slots is old  # unchanged: no new window
        d.set_max_inflight(0)
        assert d.max_inflight == 1 and d._slots is not old
        d.set_window_ms(7.0)
        assert d.window_ms == 7.0
        d.set_window_ms(-1.0)
        assert d.window_ms == 0.0
        d.set_deadline_safety(0.5)
        assert d.deadline_safety == 1.0
        d.set_bucket_floor(0)
        assert d.bucket_floor == 1
        assert [d.bucket_for(n) for n in (1, 3, 8)] == [1, 4, 8]
        d.set_bucket_floor(4)
        # nothing captured yet: the floor waits for a captured bucket
        assert d.bucket_for(1) == 1
        d.warmed.update({("", 0, 2), ("", 0, 4), ("aux", 0, 2)})
        assert [d.bucket_for(n) for n in (1, 3, 5)] == [4, 4, 8]
        assert d.bucket_for(1, "aux") == 2
        d.set_bucket_floor(64)  # clamped to max_batch's bucket
        d.warmed.add(("", 0, 8))
        assert d.bucket_for(1) == 8
    finally:
        d.stop()


def _checksum(frames, depths, intr, scales):
    """A batched analyzer whose packed rows depend on every input byte."""
    from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
    from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe

    f = torch.as_tensor(np.asarray(frames)).to(torch.float32) / 255.0
    s = f.sum(dim=(1, 2, 3)) * (1.0 + torch.as_tensor(np.asarray(scales)))
    score = torch.sin(s) + torch.sqrt(s + 0.5)
    b = f.shape[0]
    zero = torch.zeros(b)
    prof = tgeom.CurvatureProfile(
        mean_curvature=score, max_curvature=zero,
        spline_points=torch.zeros(b, 2, 3),
        valid=torch.ones(b, dtype=torch.bool),
        num_cloud_points=torch.zeros(b, dtype=torch.int32),
        num_edge_points=torch.zeros(b, dtype=torch.int32),
        truncated=torch.zeros(b, dtype=torch.bool))
    out = tpipe.FrameAnalysis(
        mask=torch.zeros(b, 8, 8, dtype=torch.uint8), mask_coverage=score,
        profile=prof, confidence_margin=zero)
    return tpipe.pack_analysis(out, n_pts=2)


def test_serial_parity_with_controller_running_but_idle():
    """The JAX package's test_serial_parity_with_controller_running_but_
    idle on the port's dispatcher: serial depth-1 results stay bit for
    bit with the controller enabled but idle (a dead-band burn)."""
    frames = [np.random.default_rng(i).integers(0, 255, (8, 8, 3),
                                                dtype=np.uint8)
              for i in range(6)]

    def run(with_controller: bool):
        d = BatchDispatcher(_checksum, window_ms=1.0, max_batch=2,
                            max_inflight=1, watchdog_interval_s=0.0,
                            device="cpu")
        c = None
        if with_controller:
            c = controller.ReactiveController(
                dispatcher=lambda: d, burn=lambda: 0.7, interval_s=0.01)
            c.start()
        try:
            out = []
            for f in frames:
                r = d.submit(f, _DEPTH, _K, 0.001, timeout_s=30.0)
                out.append(r.payload.tobytes())
                r.release()
            return out
        finally:
            if c is not None:
                c.stop()
                assert c.actions_total == 0
            d.stop()

    assert run(True) == run(False)


# -- the servicer -------------------------------------------------------------


def _folded():
    net = tunet.UNet(config.ModelConfig(base_features=4,
                                        compute_dtype="float32"))
    net.init_weights(torch.Generator().manual_seed(0)).eval()
    return FoldedUNet(net, device="cpu")


def _cfg(tmp_path, **fields):
    return config.ServerConfig(
        model_img_size=32, metrics_csv=str(tmp_path / "m.csv"),
        calibration_path=str(tmp_path / "none.npz"), **fields)


def _requests(n=3):
    rng = np.random.default_rng(5)
    return [ingest.raw_request(
        rng.integers(0, 255, (24, 32, 3), dtype=np.uint8),
        rng.integers(400, 900, (24, 32), dtype=np.uint16), mask_format=1)
        for _ in range(n)]


def test_controller_is_built_only_with_an_objective_and_batching(tmp_path):
    folded = _folded()
    on = dict(controller_enabled=True)
    for fields, built in (
            (dict(slo_ms=100.0, batch_window_ms=2.0), True),
            (dict(slo_ms=0.0, batch_window_ms=2.0), False),
            (dict(slo_ms=100.0, batch_window_ms=0.0), False)):
        service = VisionAnalysisService(folded, cfg=_cfg(tmp_path, **on,
                                                         **fields),
                                        device="cpu")
        try:
            assert (service.controller is not None) is built
            if built:
                # the live generation's dispatcher, read through a callable
                assert service.controller._dispatcher() is service.dispatcher
        finally:
            service.close()
        if built:
            assert service.controller._thread is None  # close() stopped it


def test_rung_three_refuses_every_other_new_stream(tmp_path):
    """With the refusal on, odd new streams are refused
    (StreamRefusedError, UNAVAILABLE over gRPC) and even ones served; off
    again, every stream is served."""
    service = VisionAnalysisService(
        _folded(), cfg=_cfg(tmp_path, batch_window_ms=2.0, slo_ms=100.0,
                            controller_enabled=True,
                            controller_interval_s=60.0),
        device="cpu")
    try:
        service._set_refuse_streams(True)
        outcomes = []
        for _ in range(6):
            try:
                got = list(service.analyze_stream(iter(_requests(1))))
                outcomes.append(got[0].status.split(":")[0])
            except StreamRefusedError:
                outcomes.append("refused")
        assert outcomes == ["refused", "OK", "refused", "OK", "refused",
                            "OK"] or outcomes == [
            "refused", "DEGRADED", "refused", "DEGRADED", "refused",
            "DEGRADED"]
        service._set_refuse_streams(False)
        for _ in range(3):
            assert len(list(service.analyze_stream(iter(_requests(1))))) == 1
    finally:
        service.close()


def test_rung_three_answers_unavailable_over_grpc(tmp_path):
    grpc = pytest.importorskip("grpc")
    from robotic_discovery_platform_tpu_torch.serving import grpc_service
    from robotic_discovery_platform_tpu_torch.serving.proto import (
        vision_grpc,
    )

    server, service = grpc_service.build_server(
        _cfg(tmp_path, address="localhost:0", batch_window_ms=2.0,
             slo_ms=100.0, controller_enabled=True,
             controller_interval_s=60.0), _folded(), device="cpu")
    server.start()
    channel = grpc.insecure_channel(f"localhost:{service.bound_port}")
    try:
        stub = vision_grpc.VisionAnalysisServiceStub(channel)
        service._set_refuse_streams(True)
        codes = []
        for _ in range(4):
            try:
                list(stub.AnalyzeActuatorPerformance(
                    iter([_proto(_requests(1)[0])]), timeout=60))
                codes.append("OK")
            except grpc.RpcError as exc:
                codes.append(exc.code().name)
        assert codes == ["UNAVAILABLE", "OK", "UNAVAILABLE", "OK"]
    finally:
        channel.close()
        server.stop(grace=None)
        service.close()


def _proto(req):
    from robotic_discovery_platform_tpu_torch.serving.proto import vision_pb2

    def image(img):
        return vision_pb2.Image(data=img.data, width=img.width,
                                height=img.height, format=img.format)

    return vision_pb2.AnalysisRequest(
        color_image=image(req.color_image), depth_image=image(req.depth_image),
        model=req.model, mask_format=req.mask_format)


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_idle_controller_leaves_responses_bit_for_bit(batched, tmp_path):
    """An enabled controller whose objective is far above any latency
    never acts, and every response equals the controller-off servicer's
    (JAX tests/test_controller.py:664 on the port's servicer)."""
    folded = _folded()
    fields = dict(batch_window_ms=2.0 if batched else 0.0,
                  max_inflight_dispatches=1, slo_ms=1e6)

    def run(enabled):
        service = VisionAnalysisService(
            folded, cfg=_cfg(tmp_path, controller_enabled=enabled,
                             controller_interval_s=0.01,
                             controller_sustain_s=0.0,
                             controller_cooldown_s=0.0, **fields),
            device="cpu")
        try:
            out = [(r.status, r.mask, r.mask_coverage, r.mean_curvature,
                    r.max_curvature, r.packed_spline)
                   for r in service.analyze_stream(iter(_requests(6)))]
            if service.controller is not None:
                assert service.controller.actions_total == 0
                assert service.controller.level == 0
            return out, service.controller is not None
        finally:
            service.close()

    on, built = run(True)
    off, _ = run(False)
    assert built is batched
    assert on == off
