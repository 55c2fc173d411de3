"""The port's drift-triggered rollout (serving/rollout.py and the drain,
shadow and promotion wiring in serving/server.py) against the JAX
package's, on the CPU.

Every fake-target state-machine scenario of the JAX package's
tests/test_rollout.py (the happy path, each rollback, the timeouts, the
cooperative cancel, the single replica, the busy skip, the worker thread,
the shadow runner's units) runs on the JAX manager and on the port's:
the same outcomes, stage sequences, gate verdicts, target states and
counter increments. evaluate_gates gives the same verdicts over the JAX
gate matrix. A live cycle on two in-process replicas under a stream, a
zeroed-head candidate then a faithful one (JAX tests/test_rollout.py:790),
ends in the same states with the same promoted version in both packages.

Tolerances, fixed before measuring: none. Outcomes, stages, verdicts,
versions and counter increments are compared exactly; the shadow
reports' floats are compared exactly too (the same fake analyses).
"""

import copy
import dataclasses
import queue
import threading
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.observability import instruments as jobs
from robotic_discovery_platform_tpu.serving import rollout as jrollout
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as tobs,
)
from robotic_discovery_platform_tpu_torch.serving import grpc_service
from robotic_discovery_platform_tpu_torch.serving import rollout as trollout
from robotic_discovery_platform_tpu_torch.utils import config

H, W, SIZE = 120, 160, 64
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


# -- fakes (the JAX test's, for either package) -------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class FakeProfile(NamedTuple):
    valid: object
    mean_curvature: object
    max_curvature: object


class FakeAnalysis(NamedTuple):
    mask: object
    mask_coverage: object
    profile: FakeProfile
    confidence_margin: object


def _analysis(mask, mean_k=1.0, valid=True, margin=0.3):
    cov = 100.0 * float(np.count_nonzero(mask)) / mask.size
    return FakeAnalysis(
        mask=mask, mask_coverage=np.float32(cov),
        profile=FakeProfile(valid=np.bool_(valid),
                            mean_curvature=np.float32(mean_k),
                            max_curvature=np.float32(2 * mean_k)),
        confidence_margin=np.float32(margin))


def _sample(lib, mask=None, mean_k=1.0, valid=True):
    mask = mask if mask is not None else np.ones((8, 8), np.uint8)
    return lib.ShadowSample(
        rgb=np.zeros((8, 8, 3), np.uint8),
        depth=np.full((8, 8), 500, np.uint16),
        k=np.eye(3, dtype=np.float32), depth_scale=0.001, mask=mask,
        coverage=100.0 * float(np.count_nonzero(mask)) / mask.size,
        mean_curvature=mean_k, max_curvature=2 * mean_k, valid=valid,
        confidence_margin=0.3, depth_valid_fraction=1.0)


class FakeTarget:
    """The rollout target surface, no servicer behind it."""

    def __init__(self, lib, name, streams=0, version=1):
        self.lib = lib
        self.name = name
        self.streams = streams
        self.current_version = version
        self.draining = False
        self.shadow_hook = None
        self.promote_calls = 0
        self.promote_to = None
        self.feed_on_shadow = 0

    @property
    def active_streams(self):
        return self.streams() if callable(self.streams) else self.streams

    def set_draining(self, draining):
        self.draining = bool(draining)

    def set_shadow(self, hook):
        self.shadow_hook = hook
        if hook is not None:
            for _ in range(self.feed_on_shadow):
                hook(_sample(self.lib))

    def promote(self):
        self.promote_calls += 1
        if self.promote_to is not None:
            self.current_version = self.promote_to
        return True

    def reference_analyzer(self):
        return lambda rgb, depth, k, scale: _analysis(
            np.ones((8, 8), np.uint8))

    def state(self):
        return (self.name, self.draining, self.current_version,
                self.shadow_hook is None)


class FakeResult(NamedTuple):
    succeeded: bool
    version: object
    message: str = ""


def _stub_class(lib):
    """The manager with its model-touching edges stubbed, for ``lib``:
    the JAX candidate takes (variables, ...), the port's (rgb, ...)."""
    jax_side = lib is jrollout

    class StubManager(lib.RolloutManager):
        def __init__(self, *args, candidate_mask=None, fixture=None,
                     promote_error=None, **kwargs):
            super().__init__(*args, **kwargs)
            self._cand_mask = (candidate_mask if candidate_mask is not None
                               else np.ones((8, 8), np.uint8))
            self._fixture = fixture or {
                "mask_iou_mean": 1.0, "curvature_err_max": 0.0}
            self._promote_error = promote_error

        def _load_candidate(self, version):
            mask = self._cand_mask
            if jax_side:
                return (lambda variables, rgb, depth, k, scale:
                        _analysis(mask)), {}
            return lambda rgb, depth, k, scale: _analysis(mask)

        def _fixture_report(self, reference, cand_analyze, *rest):
            return dict(self._fixture)

        def _promote(self, cycle, version):
            if self._promote_error is not None:
                raise self._promote_error
            for t in self.targets:
                t.promote_to = int(version)
                t.promote()

    return StubManager


def _stub(lib, targets, clock=None, train_fn=None, **cfg_kw):
    clock = clock or FakeClock()
    defaults = dict(
        shadow_fraction=1.0, shadow_min_frames=2, shadow_queue=16,
        drain_timeout_s=2.0, retrain_timeout_s=2.0, shadow_timeout_s=2.0,
        promote_timeout_s=2.0, gate_shadow_min_iou=0.5,
        gate_shadow_max_psi=1.0)
    defaults.update(cfg_kw)
    stub_kw = {k: defaults.pop(k) for k in
               ("candidate_mask", "fixture", "promote_error")
               if k in defaults}
    cfg_lib = jconfig if lib is jrollout else config
    extra = {} if lib is jrollout else {"device": "cpu"}
    mgr = _stub_class(lib)(
        targets, cfg_lib.RolloutConfig(**defaults), cfg_lib.ServerConfig(),
        train_fn=train_fn or (lambda target: FakeResult(True, 7)),
        clock=clock, sleep=clock.sleep, **stub_kw, **extra)
    return mgr, clock


def _rec(reason="test excursion"):
    class Rec:
        signals = ["mask_coverage"]

    Rec.reason = reason
    return Rec()


def _obs(lib):
    return jobs if lib is jrollout else tobs


def _counters(lib) -> dict:
    o = _obs(lib)
    out = {}
    for s in ("draining", "retraining", "shadow", "canary", "promoting",
              "rejoining", "idle"):
        out[f"to_{s}"] = o.ROLLOUT_TRANSITIONS.labels(to=s).value
        out[f"rb_{s}"] = o.ROLLOUT_ROLLBACKS.labels(stage=s).value
    for outcome in ("promoted", "rolled_back"):
        out[outcome] = o.ROLLOUT_CYCLES.labels(outcome=outcome).value
    for reason in ("busy", "no_spare_replica"):
        out[reason] = o.ROLLOUT_SKIPPED.labels(reason=reason).value
    for outcome in ("mirrored", "dropped", "diffed", "error"):
        out[f"shadow_{outcome}"] = o.ROLLOUT_SHADOW_FRAMES.labels(
            outcome=outcome).value
    out["cancels"] = o.ROLLOUT_RETRAIN_CANCELS.value
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _summary(cycle: dict) -> dict:
    """A cycle record without its clock stamps."""
    gates = cycle.get("gates")
    return {
        "outcome": cycle["outcome"],
        "rolled_back_at": cycle.get("rolled_back_at"),
        "replica": cycle.get("replica"),
        "candidate_version": cycle["candidate_version"],
        "stages": [s["stage"] for s in cycle["stages"]],
        "gates": ({g: (v["value"], v["threshold"], v["pass"])
                   for g, v in gates.items()} if gates else None),
        "shadow": cycle.get("shadow"),
        "error": cycle.get("error", "").split(":")[0],
    }


# -- the scenarios, each run on both packages ---------------------------------


def _happy_path(lib):
    a, b = FakeTarget(lib, "a", streams=2), FakeTarget(lib, "b", streams=0)
    a.feed_on_shadow = 4
    mgr, _ = _stub(lib, [a, b])
    cycle = mgr.run_cycle(_rec())
    assert cycle["outcome"] == "promoted" and cycle["replica"] == "b"
    assert [s["stage"] for s in cycle["stages"]] == [
        lib.DRAINING, lib.RETRAINING, lib.SHADOW, lib.CANARY,
        lib.PROMOTING, lib.REJOINING]
    assert a.current_version == b.current_version == 7
    assert b.draining is False and a.shadow_hook is None
    assert mgr.state == lib.IDLE
    snap = mgr.snapshot()
    assert snap["history"][-1]["outcome"] == "promoted"
    return cycle, [a, b], {k: v for k, v in snap.items()
                           if k not in ("history", "current")}


def _gate_failure(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")
    a.feed_on_shadow = 4
    mgr, _ = _stub(lib, [a, b], candidate_mask=np.zeros((8, 8), np.uint8),
                   fixture={"mask_iou_mean": 0.0, "curvature_err_max": 0.0})
    cycle = mgr.run_cycle(_rec())
    assert cycle["outcome"] == "rolled_back"
    assert cycle["rolled_back_at"] == lib.CANARY
    failed = {g for g, v in cycle["gates"].items() if not v["pass"]}
    assert {"fixture_iou", "shadow_iou"} <= failed
    assert a.current_version == b.current_version == 1
    assert b.draining is False and mgr.state == lib.IDLE
    return cycle, [a, b], None


def _retrain_failure(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")
    mgr, _ = _stub(lib, [a, b], train_fn=lambda t: FakeResult(
        False, None, "training exploded"))
    cycle = mgr.run_cycle(_rec())
    assert cycle["rolled_back_at"] == lib.RETRAINING
    assert "training exploded" in cycle["error"]
    assert b.draining is False and mgr.state == lib.IDLE
    return cycle, [a, b], None


def _retrain_crash(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")

    def boom(target):
        raise RuntimeError("OOM mid-epoch")

    mgr, _ = _stub(lib, [a, b], train_fn=boom)
    cycle = mgr.run_cycle(_rec())
    assert cycle["outcome"] == "rolled_back"
    assert "OOM mid-epoch" in cycle["error"]
    assert b.draining is False and mgr.state == lib.IDLE
    return cycle, [a, b], None


def _drain_timeout(lib):
    a = FakeTarget(lib, "a", streams=1)
    b = FakeTarget(lib, "b", streams=0)
    b.streams = 1  # never drains
    mgr, _ = _stub(lib, [a, b], drain_timeout_s=0.5)
    cycle = mgr.run_cycle(_rec())
    assert cycle["rolled_back_at"] == lib.DRAINING
    assert b.draining is False, "rollback must un-drain the stuck replica"
    assert mgr.state == lib.IDLE
    return cycle, [a, b], None


def _retrain_timeout(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")
    release = threading.Event()
    seen = {}

    def hung_train(target, cancel):
        seen["cancel"] = cancel
        release.wait(timeout=30)
        return FakeResult(True, 9)

    mgr, _ = _stub(lib, [a, b], train_fn=hung_train, retrain_timeout_s=0.5)
    try:
        cycle = mgr.run_cycle(_rec())
    finally:
        release.set()
    assert cycle["rolled_back_at"] == lib.RETRAINING
    assert "stop at its next stage boundary" in cycle["error"]
    assert seen["cancel"].is_set()
    assert a.current_version == b.current_version == 1
    assert b.draining is False and mgr.state == lib.IDLE
    return cycle, [a, b], None


def _quick_train_sees_no_cancel(lib):
    quick = {}

    def quick_train(target, cancel):
        quick["cancel"] = cancel
        return FakeResult(True, 7)

    live, spare = FakeTarget(lib, "a", streams=2), FakeTarget(lib, "b")
    live.feed_on_shadow = 4
    mgr, _ = _stub(lib, [live, spare], train_fn=quick_train)
    cycle = mgr.run_cycle(_rec())
    assert cycle["outcome"] == "promoted"
    assert not quick["cancel"].is_set()
    return cycle, [live, spare], None


def _shadow_timeout(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")
    mgr, _ = _stub(lib, [a, b], shadow_timeout_s=0.5, shadow_min_frames=4)
    cycle = mgr.run_cycle(_rec())
    assert cycle["rolled_back_at"] == lib.CANARY
    assert not cycle["gates"]["shadow_frames"]["pass"]
    assert a.current_version == b.current_version == 1
    return cycle, [a, b], None


def _promote_failure(lib):
    a, b = FakeTarget(lib, "a", streams=1), FakeTarget(lib, "b")
    a.feed_on_shadow = 4
    mgr, _ = _stub(lib, [a, b],
                   promote_error=RuntimeError("registry unreachable"))
    cycle = mgr.run_cycle(_rec())
    assert cycle["rolled_back_at"] == lib.PROMOTING
    assert b.draining is False and mgr.state == lib.IDLE
    return cycle, [a, b], None


def _single_replica(lib):
    only = FakeTarget(lib, "only")
    mgr, _ = _stub(lib, [only])
    cycle = mgr.run_cycle(_rec())
    assert cycle["outcome"] == "skipped" and only.draining is False
    return cycle, [only], None


SCENARIOS = {
    "happy_path": _happy_path, "gate_failure": _gate_failure,
    "retrain_failure": _retrain_failure, "retrain_crash": _retrain_crash,
    "drain_timeout": _drain_timeout, "retrain_timeout": _retrain_timeout,
    "quick_train": _quick_train_sees_no_cancel,
    "shadow_timeout": _shadow_timeout, "promote_failure": _promote_failure,
    "single_replica": _single_replica,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_decides_as_jax(name):
    """Each scenario on both managers: the same cycle record (outcome,
    stage sequence, gate values and verdicts, shadow report), the same
    target states and the same counter increments."""
    seen = {}
    for lib in (jrollout, trollout):
        before = _counters(lib)
        cycle, targets, snap = SCENARIOS[name](lib)
        seen[lib] = (_summary(cycle), [t.state() for t in targets], snap,
                     _delta(before, _counters(lib)))
    assert seen[trollout] == seen[jrollout]


def test_shadow_stage_ends_while_frames_keep_arriving():
    """A live replica mirrors frames faster than the candidate diffs them:
    the port closes the tap, then diffs what it mirrored, so the stage
    ends (the JAX package drains with the tap open, which does not end
    while frames keep coming)."""
    stop = threading.Event()

    class Busy(FakeTarget):
        def set_shadow(self, hook):
            self.shadow_hook = hook
            if hook is not None:
                def feed():
                    while self.shadow_hook is hook and not stop.is_set():
                        hook(_sample(trollout))
                        time.sleep(0.001)
                threading.Thread(target=feed, daemon=True).start()

    a, b = Busy(trollout, "a", streams=1), FakeTarget(trollout, "b")
    mgr = _stub_class(trollout)(
        [a, b], config.RolloutConfig(
            shadow_fraction=1.0, shadow_min_frames=4, shadow_queue=64),
        config.ServerConfig(), train_fn=lambda t: FakeResult(True, 7),
        device="cpu")
    slow = mgr._load_candidate

    def load(version):
        analyze = slow(version)

        def slow_analyze(*args):
            time.sleep(0.005)
            return analyze(*args)

        return slow_analyze

    mgr._load_candidate = load
    t0 = time.monotonic()
    try:
        cycle = mgr.run_cycle(_rec())
    finally:
        stop.set()
    assert time.monotonic() - t0 < 30
    assert cycle["outcome"] == "promoted"
    assert cycle["shadow"]["frames"] >= 4


@pytest.mark.parametrize("lib", [jrollout, trollout], ids=["jax", "port"])
def test_env_resolve(lib, monkeypatch):
    monkeypatch.delenv("RDP_ROLLOUT", raising=False)
    assert lib.resolve_rollout_enabled(False) is False
    assert lib.resolve_rollout_enabled(True) is True
    monkeypatch.setenv("RDP_ROLLOUT", "1")
    assert lib.resolve_rollout_enabled(False) is True
    monkeypatch.setenv("RDP_ROLLOUT", "off")
    assert lib.resolve_rollout_enabled(True) is False


def test_recommendation_skipped_while_busy():
    got = {}
    for lib in (jrollout, trollout):
        a, b = FakeTarget(lib, "a"), FakeTarget(lib, "b")
        mgr, _ = _stub(lib, [a, b])
        before = _counters(lib)
        with mgr._lock:
            mgr._state = lib.SHADOW
        first = mgr.on_recommendation(_rec())
        with mgr._lock:
            mgr._state = lib.IDLE
        second = mgr.on_recommendation(_rec())
        got[lib] = (first, second, _delta(before, _counters(lib)))
    assert got[trollout] == got[jrollout] == (False, True, {"busy": 1})


def test_worker_thread_services_recommendations():
    a, b = FakeTarget(trollout, "a", streams=1), FakeTarget(trollout, "b")
    a.feed_on_shadow = 4
    mgr, _ = _stub(trollout, [a, b])
    mgr.start()
    try:
        assert mgr.on_recommendation(_rec()) is True
        deadline = time.monotonic() + 10
        while not mgr.history and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr.history and mgr.history[-1]["outcome"] == "promoted"
    finally:
        mgr.stop()


def test_retraining_pipeline_honors_preset_cancel():
    """A cancel flag already set stops the port's pipeline before any
    training, as the JAX one does."""
    from robotic_discovery_platform_tpu.workflows import retraining as jret
    from robotic_discovery_platform_tpu_torch.workflows import (
        retraining as tret,
    )

    cancel = threading.Event()
    cancel.set()
    res = tret.run_retraining_pipeline(cancel=cancel, device="cpu")
    want = jret.run_retraining_pipeline(cancel=cancel)
    assert (res.succeeded, res.version, res.promoted_alias, res.message) == (
        want.succeeded, want.version, want.promoted_alias, want.message)
    assert "cancelled before training" in res.message


# -- the gates ----------------------------------------------------------------


def _reports(**overrides):
    fixture = {"mask_iou_mean": 1.0, "curvature_err_max": 0.0}
    shadow = {"frames": 32, "mask_iou_mean": 1.0, "curvature_err_max": 0.0,
              "psi_max": 0.0}
    for k, v in overrides.items():
        (fixture if k.startswith("f_") else shadow)[k[2:]] = v
    return fixture, shadow


@pytest.mark.parametrize("overrides,failed_gate", [
    ({}, None),
    ({"f_mask_iou_mean": 0.5}, "fixture_iou"),
    ({"f_curvature_err_max": 5.0}, "fixture_curv"),
    ({"s_frames": 1}, "shadow_frames"),
    ({"s_mask_iou_mean": 0.1}, "shadow_iou"),
    ({"s_curvature_err_max": 5.0}, "shadow_curv"),
    ({"s_psi_max": 10.0}, "shadow_psi"),
    ({"f_mask_iou_mean": 0.8, "s_mask_iou_mean": 0.5, "s_frames": 16,
      "f_curvature_err_max": 1.0, "s_curvature_err_max": 1.0,
      "s_psi_max": 1.0}, None),  # every value at its threshold passes
])
def test_gate_matrix(overrides, failed_gate):
    fixture, shadow = _reports(**overrides)
    got = trollout.evaluate_gates(
        config.RolloutConfig(shadow_min_frames=16), fixture, shadow)
    want = jrollout.evaluate_gates(
        jconfig.RolloutConfig(shadow_min_frames=16), fixture, shadow)
    assert got == want
    passed, verdicts = got
    if failed_gate is None:
        assert passed
    else:
        assert not passed
        assert {g for g, v in verdicts.items() if not v["pass"]} == {
            failed_gate}


def test_rollout_config_matches_jax():
    assert (dataclasses.asdict(config.RolloutConfig())
            == dataclasses.asdict(jconfig.RolloutConfig()))
    cfg = config.from_dict(config.PlatformConfig,
                           {"rollout": {"shadow_min_frames": 3,
                                        "enabled": True}})
    assert cfg.rollout.shadow_min_frames == 3 and cfg.rollout.enabled
    assert config.parse_config(["--rollout.candidate_alias", "cand"]
                               ).rollout.candidate_alias == "cand"


# -- the shadow runner --------------------------------------------------------


def _runner(lib, mask=None, fraction=1.0, max_queue=8, broken=False):
    mask = mask if mask is not None else np.ones((8, 8), np.uint8)

    def analyze(*args):
        if broken:
            raise ValueError("candidate NaN")
        return _analysis(mask)

    if lib is jrollout:
        return lib.ShadowRunner(analyze, {}, fraction=fraction,
                                max_queue=max_queue)
    return lib.ShadowRunner(analyze, fraction=fraction, max_queue=max_queue)


@pytest.mark.parametrize("case", ["identical", "divergent", "fraction",
                                  "overflow", "error"])
def test_shadow_runner_as_jax(case):
    reports = {}
    for lib in (jrollout, trollout):
        kw = {"identical": {}, "divergent": {"mask": np.zeros((8, 8),
                                                              np.uint8)},
              "fraction": {"fraction": 0.25, "max_queue": 64},
              "overflow": {"max_queue": 4},
              "error": {"broken": True}}[case]
        r = _runner(lib, **kw)
        n = {"identical": 8, "divergent": 16, "fraction": 64,
             "overflow": 20, "error": 4}[case]
        t0 = time.monotonic()
        for _ in range(n):
            r.hook(_sample(lib))
        assert time.monotonic() - t0 < 1.0  # the hook never waits
        while r.process_one(timeout_s=0.0):
            pass
        reports[lib] = (r.mirrored, r.dropped, r.report())
    assert reports[trollout] == reports[jrollout]
    mirrored, dropped, rep = reports[trollout]
    if case == "identical":
        assert rep["mask_iou_mean"] == 1.0 and rep["psi_max"] < 0.5
    elif case == "divergent":
        assert rep["mask_iou_mean"] == 0.0
        assert rep["psi_max"] > config.RolloutConfig().gate_shadow_max_psi
    elif case == "fraction":
        assert (mirrored, dropped) == (16, 0)
    elif case == "overflow":
        assert (mirrored, dropped, rep["frames"]) == (4, 16, 4)
    else:
        assert rep["errors"] == 4 and rep["frames"] == 0


# -- live replicas ------------------------------------------------------------


@pytest.fixture(scope="module")
def sensitive_variables():
    """The JAX test's brightness-sensitive head (kernel x40, bias 0.5):
    live masks are not empty, so a zeroed-head candidate diverges."""
    mcfg = jconfig.ModelConfig(base_features=8, compute_dtype="float32")
    model = build_unet(mcfg)
    v = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, SIZE))(jax.random.key(0)))
    v = copy.deepcopy(v)
    v["params"]["Conv_0"]["kernel"] = (
        np.asarray(v["params"]["Conv_0"]["kernel"]) * 40.0)
    v["params"]["Conv_0"]["bias"] = np.full((1,), 0.5, np.float32)
    return mcfg, v


def _register(uri, mcfg, variables, *, zero_head=False,
              alias="staging") -> int:
    """A version of the model written by the JAX package's tracking (a
    zeroed-head candidate: logits 0, empty masks) under ``alias``."""
    v = copy.deepcopy(variables)
    if zero_head:
        v = jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)), v)
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    try:
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(v, mcfg,
                                          registered_model_name=NAME)
        jtracking.Client().set_registered_model_alias(NAME, alias, version)
    finally:
        jtracking.set_tracking_uri(prev)
    return int(version)


class _Stream:
    """A gRPC stream of synthetic frames into one replica until stopped,
    counting frames sent, answered and errored."""

    def __init__(self, grpc, stub, encode):
        self.sent = self.received = self.errors = 0
        self._stop = threading.Event()
        self._outbox: queue.Queue = queue.Queue(maxsize=4)
        rng = np.random.default_rng(3)
        frames = [render_scene(rng, H, W) for _ in range(4)]

        def feeder():
            i = 0
            while not self._stop.is_set():
                rgb, _, depth = frames[i % len(frames)]
                i += 1
                try:
                    self._outbox.put(encode(rgb, depth), timeout=0.1)
                except queue.Full:
                    continue

        def gen():
            # never blocks for good: the stream ends once stop() is called
            while not self._stop.is_set():
                try:
                    item = self._outbox.get(timeout=0.1)
                except queue.Empty:
                    continue
                self.sent += 1
                yield item
                time.sleep(0.02)

        self._call = stub.AnalyzeActuatorPerformance(gen())

        def drain():
            try:
                for resp in self._call:
                    self.received += 1
                    if resp.status.startswith("ERROR"):
                        self.errors += 1
            except grpc.RpcError:
                self.errors += 1

        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (feeder, drain)]
        for t in self._threads:
            t.start()

    def wait_for(self, n, timeout=60):
        deadline = time.monotonic() + timeout
        while self.received < n and time.monotonic() < deadline:
            time.sleep(0.05)
        return self.received >= n

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)


def _rollout_cfg(lib):
    return lib.RolloutConfig(
        shadow_fraction=1.0, shadow_min_frames=3, gate_shadow_min_iou=0.5,
        gate_shadow_max_psi=1.0, gate_fixture_min_iou=0.8,
        gate_fixture_frames=2, drain_timeout_s=30.0, retrain_timeout_s=120.0,
        shadow_timeout_s=60.0, promote_timeout_s=60.0)


def _live_cycles(port: bool, uri: str, tmp_path, mcfg, good) -> dict:
    """Two replicas of one registry, a stream into the first, and two
    cycles: a zeroed-head candidate, then a faithful one."""
    grpc = pytest.importorskip("grpc")
    lib = trollout if port else jrollout
    cfg_lib = config if port else jconfig
    phase = {"zero_head": True}

    def train_fn(target):
        version = _register(uri, mcfg, good, zero_head=phase["zero_head"],
                            alias="shadow")
        return FakeResult(True, version)

    servers = []
    for i in range(2):
        cfg = cfg_lib.ServerConfig(
            address="localhost:0", tracking_uri=uri, model_img_size=SIZE,
            metrics_csv=str(tmp_path / f"{port}-{i}.csv"),
            metrics_flush_every=1000,
            calibration_path=str(tmp_path / "none.npz"), reload_poll_s=0.0)
        if port:
            server, sv = grpc_service.build_server(cfg, device="cpu")
            endpoint = f"localhost:{sv.bound_port}"
        else:
            server, sv = jserver.build_server(cfg)
            endpoint = f"localhost:{server.add_insecure_port('localhost:0')}"
        server.start()
        servers.append((server, sv, endpoint, cfg))
    (_, sv1, ep1, cfg1), (_, sv2, _, _) = servers
    if port:
        from robotic_discovery_platform_tpu_torch.serving import client
        from robotic_discovery_platform_tpu_torch.serving.proto import (
            vision_grpc,
        )
    else:
        from robotic_discovery_platform_tpu.serving import client
        from robotic_discovery_platform_tpu.serving.proto import vision_grpc
    channel = grpc.insecure_channel(ep1)
    extra = {"device": "cpu"} if port else {}
    mgr = lib.RolloutManager([], _rollout_cfg(cfg_lib), cfg1,
                             train_fn=train_fn, **extra)
    lib.attach_rollout(mgr, [sv1, sv2], names=["r1", "r2"])
    try:
        v0 = sv1.current_version
        stream = _Stream(grpc, vision_grpc.VisionAnalysisServiceStub(channel),
                         lambda rgb, depth: client.encode_request(
                             rgb[..., ::-1], depth, fmt="raw"))
        try:
            assert stream.wait_for(2)
            first = mgr.run_cycle(_rec("injected for test"))
            after_first = (sv1.current_version, sv2.current_version,
                           sv1.is_draining, sv2.is_draining)
            phase["zero_head"] = False
            second = mgr.run_cycle(_rec("second excursion"))
            refs = [sv.version_and_reference() for sv in (sv1, sv2)]
        finally:
            stream.stop()
        store = (tracking if port else jtracking).store_for(uri)
        return {
            "v0": v0, "first": _live_summary(first), "after_first":
            after_first, "second": _live_summary(second),
            "versions": (sv1.current_version, sv2.current_version),
            "references": refs,
            "staging": store.get_alias(NAME, "staging"),
            "outcomes": [c["outcome"] for c in mgr.snapshot()["history"]],
            "stream": (stream.errors, stream.received == stream.sent),
        }
    finally:
        channel.close()
        for server, sv, _, _ in servers:
            server.stop(grace=None)
            sv.close()


#: the gates whose verdicts do not depend on how many frames the live
#: stream mirrored before the shadow stage closed (the PSI of a handful of
#: frames against another handful does, in either package)
FRAME_COUNT_FREE_GATES = ("fixture_iou", "fixture_curv", "shadow_iou")


def _live_summary(cycle):
    return {"outcome": cycle["outcome"],
            "rolled_back_at": cycle.get("rolled_back_at"),
            "replica": cycle.get("replica"),
            "candidate_version": cycle["candidate_version"],
            "stages": [s["stage"] for s in cycle["stages"]],
            "failed": sorted(g for g, v in (cycle.get("gates") or {}).items()
                             if not v["pass"]
                             and g in FRAME_COUNT_FREE_GATES)}


def test_live_cycle_bad_then_good_candidate_as_jax(sensitive_variables,
                                                   tmp_path):
    """JAX tests/test_rollout.py:790 on both packages, each over its own
    registry of the same versions: the zeroed-head candidate is refused at
    CANARY by its shadow gate and nothing moves; the faithful one promotes
    on both replicas, whose engine and drift reference move together; a
    stream into the serving replica answers every frame throughout."""
    mcfg, good = sensitive_variables
    got = {}
    for port in (False, True):
        uri = f"file:{tmp_path / f'mlruns-{port}'}"
        _register(uri, mcfg, good)
        got[port] = _live_cycles(port, uri, tmp_path, mcfg, good)
    assert got[True] == got[False]
    out = got[True]
    assert out["first"]["outcome"] == "rolled_back"
    assert out["first"]["rolled_back_at"] == "canary"
    assert "shadow_iou" in out["first"]["failed"]
    assert out["after_first"] == (out["v0"], out["v0"], False, False)
    assert out["second"]["outcome"] == "promoted", out["second"]
    v_new = out["second"]["candidate_version"]
    assert out["versions"] == (v_new, v_new)
    assert out["references"] == [(v_new, v_new), (v_new, v_new)]
    assert out["staging"] == v_new
    assert out["outcomes"] == ["rolled_back", "promoted"]
    assert out["stream"] == (0, True)


def test_set_draining_keeps_health_and_refuses_new_streams(tmp_path):
    """set_draining refuses new streams with health SERVING, an in-flight
    stream finishes, and un-draining accepts streams again; the shutdown
    drain() is apart from it."""
    from robotic_discovery_platform_tpu_torch.models import unet as tunet
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
    from robotic_discovery_platform_tpu_torch.serving import health, ingest
    from robotic_discovery_platform_tpu_torch.serving.server import (
        VISION_SERVICE,
        StreamRefusedError,
        VisionAnalysisService,
    )

    net = tunet.UNet(config.ModelConfig(base_features=4,
                                        compute_dtype="float32"))
    net.init_weights(torch.Generator().manual_seed(0)).eval()
    service = VisionAnalysisService(
        FoldedUNet(net, device="cpu"),
        cfg=config.ServerConfig(model_img_size=32,
                                metrics_csv=str(tmp_path / "m.csv")),
        device="cpu")
    service.mark_ready()
    rng = np.random.default_rng(1)

    def request():
        return ingest.raw_request(
            rng.integers(0, 255, (24, 32, 3), dtype=np.uint8),
            rng.integers(400, 900, (24, 32), dtype=np.uint16))

    try:
        inflight = service.analyze_stream(iter([request(), request()]))
        first = next(inflight)  # the stream is in flight
        service.set_draining(True)
        assert service.is_draining and service.active_streams == 1
        assert service.health.get(VISION_SERVICE) == health.SERVING
        with pytest.raises(StreamRefusedError):
            next(service.analyze_stream(iter([request()])))
        rest = list(inflight)  # the in-flight stream finishes
        assert first.status and len(rest) == 1
        assert service.active_streams == 0
        service.set_draining(False)
        assert len(list(service.analyze_stream(iter([request()])))) == 1
        # a failing shadow tap never fails a frame
        calls = []

        def tap(sample):
            calls.append(sample)
            raise RuntimeError("tap broke")

        service.set_shadow(tap)
        got = list(service.analyze_stream(iter([request()])))
        assert got[0].status.startswith(("OK", "DEGRADED"))
        assert len(calls) == 1 and calls[0].mask.shape == (24, 32)
        service.set_shadow(None)
    finally:
        service.close()
    service.set_draining(False)  # a closed service stays drained
    assert service.is_draining
