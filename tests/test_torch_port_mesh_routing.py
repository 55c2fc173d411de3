"""The port's routed dispatcher (``serving/batching.BatchDispatcher`` over
a ``DeviceRouter`` on a ``parallel/mesh`` serving mesh) against the JAX
package's, on the CPU: the counterpart of each test of
tests/test_mesh_routing.py, plus quarantine and failover, the
controller's mode switch, the servicer's serving mesh and the config.

The JAX dispatcher runs over its virtual CPU devices (tests/conftest.py
forces 8); the port's over a ring of CPU positions
(``torch.device("cpu")`` repeated; where the port's code lists the
available devices, ``parallel/mesh.available_devices`` is monkeypatched to
8 CPU positions). Where a test gives both packages the same frames, each
frame's answer (a checksum of its pixels, exact in float32) must be the
same, and so must the per-chip dispatch counts that the JAX test holds.

Tolerances, fixed before measuring: none; answers and counts are compared
exactly, and the serial one-position ring is held bit for bit against the
router-less dispatcher on the port's real batch analyzer.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.parallel import mesh as jmesh
from robotic_discovery_platform_tpu.resilience import (
    configure_faults as jconfigure_faults,
)
from robotic_discovery_platform_tpu.serving import batching as jbatching
from robotic_discovery_platform_tpu.serving import controller as jcontroller
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.parallel import mesh as tmesh
from robotic_discovery_platform_tpu_torch.resilience import configure_faults
from robotic_discovery_platform_tpu_torch.serving import batching
from robotic_discovery_platform_tpu_torch.serving import controller
from robotic_discovery_platform_tpu_torch.serving import health
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
    DeviceRouter,
    ShardedAnalyzer,
)
from robotic_discovery_platform_tpu_torch.serving.server import (
    VisionAnalysisService,
)
from robotic_discovery_platform_tpu_torch.utils import config

_DEPTH = np.zeros((8, 8), np.uint16)
_K = np.eye(3, dtype=np.float32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_port_pipeline.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RDP_SERVING_CHIPS", "RDP_DISPATCH_MODE", "RDP_INFLIGHT"):
        monkeypatch.delenv(var, raising=False)
    # the port's available devices: 8 CPU positions, as the JAX tests' 8
    # virtual devices
    monkeypatch.setattr(tmesh, "available_devices",
                        lambda device_type="cuda": [CPU] * 8)
    yield
    configure_faults(None)
    jconfigure_faults(None)


def _frame(v: int) -> np.ndarray:
    return np.full((8, 8, 3), v, np.uint8)


def _pack_sums(frames) -> torch.Tensor:
    """Packed rows whose coverage is each frame's pixel sum (exact in
    float32 at these sizes)."""
    f = np.asarray(frames)
    b = f.shape[0]
    zero = torch.zeros(b)
    prof = tgeom.CurvatureProfile(
        mean_curvature=zero, max_curvature=zero,
        spline_points=torch.zeros(b, 2, 3),
        valid=torch.ones(b, dtype=torch.bool),
        num_cloud_points=torch.zeros(b, dtype=torch.int32),
        num_edge_points=torch.zeros(b, dtype=torch.int32),
        truncated=torch.zeros(b, dtype=torch.bool))
    sums = f.reshape(b, -1).sum(axis=1).astype(np.float32)
    out = tpipe.FrameAnalysis(
        mask=torch.zeros((b,) + f.shape[1:3], dtype=torch.uint8),
        mask_coverage=torch.from_numpy(sums), profile=prof,
        confidence_margin=zero)
    return tpipe.pack_analysis(out, n_pts=2)


class _Lazy:
    """A result whose host read blocks until ``gate`` opens: the dispatch
    stays in flight."""

    def __init__(self, rows, gate: threading.Event):
        self._rows, self._gate = rows, gate

    def __array__(self, dtype=None, copy=None):
        self._gate.wait(30.0)
        return np.asarray(self._rows.numpy(), dtype)


class _SumAnalyzer:
    """The port's ``_sum_analyze``: per-frame pixel sums as packed rows,
    optionally gated; records the rows of each call."""

    def __init__(self, gate: threading.Event | None = None):
        self.gate = gate
        self.calls: list[int] = []

    def __call__(self, frames, depths, intr, scales):
        self.calls.append(int(frames.shape[0]))
        rows = _pack_sums(frames)
        return rows if self.gate is None else _Lazy(rows, self.gate)


def _jax_sum(gate=None):
    """The JAX test's ``_sum_analyze``."""
    class _JLazy:
        def __init__(self, value):
            self._value = value

        def __array__(self, dtype=None, copy=None):
            gate.wait(30.0)
            return np.asarray(self._value, dtype)

    def analyze(frames, depths, intr, scales):
        f = np.asarray(frames)
        sums = f.reshape(f.shape[0], -1).sum(axis=1).astype(np.int64)
        return {"sum": sums if gate is None else _JLazy(sums)}

    return analyze


def _value(result) -> int:
    try:
        return int(result.scalars()[0])
    finally:
        result.release()


def _router(chips: int, mode: str = "round_robin", **kw) -> DeviceRouter:
    return DeviceRouter(tmesh.make_serving_mesh(chips), mode, **kw)


def _jrouter(chips: int, mode: str = "round_robin") -> jbatching.DeviceRouter:
    return jbatching.DeviceRouter(jmesh.make_serving_mesh(chips), mode)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# -- mesh helpers and config resolution ---------------------------------------


def test_make_serving_mesh_and_ring():
    mesh = tmesh.make_serving_mesh(4)
    assert mesh.shape == dict(jmesh.make_serving_mesh(4).shape) == {
        "data": 4, "spatial": 1, "model": 1}
    ring = tmesh.device_ring(mesh)
    assert len(ring) == 4
    assert tmesh.chip_shardings(mesh) == (CPU,) * 4
    # 0 = every device; too many chips is a hard error, in the same words
    assert len(tmesh.device_ring(tmesh.make_serving_mesh(0))) == 8
    with pytest.raises(ValueError, match="chips") as mine:
        tmesh.make_serving_mesh(9)
    with pytest.raises(ValueError, match="chips") as theirs:
        jmesh.make_serving_mesh(9)
    assert str(mine.value) == str(theirs.value)


def test_least_loaded_round_robins_ties_and_prefers_empty():
    for loads, start in [([0, 0, 0, 0], 0), ([0, 0, 0, 0], 1),
                         ([0, 0, 0, 0], 3), ([2, 1, 0, 1], 0),
                         ([1, 0, 1, 1], 3)]:
        assert tmesh.least_loaded(loads, start) == jmesh.least_loaded(
            loads, start)


@pytest.mark.parametrize("env,configured", [
    (None, 0), (None, 4), (None, -1), ("2", 0), ("-1", 0)])
def test_resolve_serving_chips_env_and_defaults(monkeypatch, env,
                                                configured):
    if env is not None:
        monkeypatch.setenv("RDP_SERVING_CHIPS", env)
    assert (batching.resolve_serving_chips(configured)
            == jbatching.resolve_serving_chips(configured))


@pytest.mark.parametrize("env,configured", [
    (None, "round_robin"), (None, "round-robin"), ("sharded", "round_robin"),
    ("bogus", "round_robin")])
def test_resolve_dispatch_mode_env_and_validation(monkeypatch, env,
                                                  configured):
    if env is not None:
        monkeypatch.setenv("RDP_DISPATCH_MODE", env)
    try:
        want = jbatching.resolve_dispatch_mode(configured)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            batching.resolve_dispatch_mode(configured)
        assert str(got.value) == str(exc)
        return
    assert batching.resolve_dispatch_mode(configured) == want


@pytest.mark.parametrize("chips,max_batch,match", [
    (3, 8, "power-of-two"), (4, 2, "multiple")])
def test_sharded_router_validates_chip_and_batch_geometry(chips, max_batch,
                                                          match):
    with pytest.raises(ValueError, match=match) as mine:
        BatchDispatcher(_SumAnalyzer(), router=_router(chips, "sharded"),
                        max_batch=max_batch, watchdog_interval_s=0.0,
                        device="cpu")
    with pytest.raises(ValueError, match=match) as theirs:
        jbatching.BatchDispatcher(_jax_sum(),
                                  router=_jrouter(chips, "sharded"),
                                  max_batch=max_batch,
                                  watchdog_interval_s=0.0)
    assert str(mine.value) == str(theirs.value)


def test_sharded_analyzer_rejects_unshardable_batches():
    """``stage_batch``'s "shard evenly" check of the JAX package: the
    port's sharded layout refuses a bucket the ring cannot split."""
    sharded = ShardedAnalyzer([_SumAnalyzer() for _ in range(4)])
    with pytest.raises(ValueError, match="shard evenly"):
        sharded(torch.zeros((2, 8, 8, 3), dtype=torch.uint8),
                torch.zeros((2, 8, 8), dtype=torch.int16),
                torch.zeros((2, 3, 3)), torch.zeros(2))


# -- round-robin routing -------------------------------------------------------


def _gated_burst(d, values, results):
    def one(v):
        try:
            out = d.submit(_frame(v), _DEPTH, _K, 0.001, timeout_s=30.0)
            results[v] = (_value(out) if isinstance(out, batching.PackedResult)
                          else int(out["sum"]))
        except BaseException as exc:  # noqa: BLE001 - recorded
            results[v] = exc

    threads = [threading.Thread(target=one, args=(v,)) for v in values]
    for t in threads:
        t.start()
    return threads


def test_round_robin_spreads_gated_dispatches_one_per_chip():
    """With per-chip windows of 1 and completion gated, 4 concurrent
    single-frame dispatches land on 4 distinct ring positions, each on its
    own analyzer, in both packages."""
    counts = {}
    for pkg in ("port", "jax"):
        gate = threading.Event()
        if pkg == "port":
            per_chip = [_SumAnalyzer(gate) for _ in range(4)]
            d = BatchDispatcher(per_chip[0], window_ms=1.0, max_batch=1,
                                max_inflight=1, device="cpu",
                                router=_router(4, analyzers=per_chip))
        else:
            d = jbatching.BatchDispatcher(_jax_sum(gate), window_ms=1.0,
                                          max_batch=1, max_inflight=1,
                                          router=_jrouter(4))
        results: dict = {}
        try:
            threads = _gated_burst(d, range(1, 5), results)
            assert _wait(lambda: sum(d.chip_dispatches) >= 4)
            counts[pkg] = list(d.chip_dispatches)
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert results == {v: 8 * 8 * 3 * v for v in range(1, 5)}
            assert d.chip_inflight_high_water == [1, 1, 1, 1]
            if pkg == "port":
                # every dispatch ran on its own position's analyzer
                assert [a.calls for a in per_chip] == [[1]] * 4
        finally:
            gate.set()
            d.stop()
    assert counts["port"] == counts["jax"] == [1, 1, 1, 1]


def test_per_stream_results_correct_across_mesh():
    got = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            d = BatchDispatcher(_SumAnalyzer(), window_ms=2.0, max_batch=4,
                                max_inflight=2, device="cpu",
                                router=_router(4))
        else:
            d = jbatching.BatchDispatcher(_jax_sum(), window_ms=2.0,
                                          max_batch=4, max_inflight=2,
                                          router=_jrouter(4))
        results: dict[int, list[int]] = {}
        try:
            def stream(sid: int):
                seq = []
                for _ in range(6):
                    out = d.submit(_frame(sid), _DEPTH, _K, 0.001,
                                   timeout_s=30.0)
                    seq.append(_value(out) if pkg == "port"
                               else int(out["sum"]))
                results[sid] = seq

            threads = [threading.Thread(target=stream, args=(s,))
                       for s in range(1, 7)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            # every frame is accounted to exactly one chip
            assert sum(d.chip_frames) == 36
        finally:
            d.stop()
        got[pkg] = results
    assert got["port"] == got["jax"]
    assert got["port"] == {s: [8 * 8 * 3 * s] * 6 for s in range(1, 7)}


def test_per_chip_inflight_caps_and_metrics_sum():
    """Each chip's window is bounded on its own; the per-chip dispatch
    counters sum to the dispatcher's total (the /metrics invariant)."""
    before = {c: obs.CHIP_DISPATCHES.labels(chip=str(c)).value
              for c in range(4)}
    gate = threading.Event()
    d = BatchDispatcher(_SumAnalyzer(gate), window_ms=1.0, max_batch=1,
                        max_inflight=2, device="cpu", router=_router(4))
    try:
        results: dict = {}
        threads = _gated_burst(d, range(1, 13), results)
        assert _wait(lambda: sum(d.chip_dispatches) >= 8)
        time.sleep(0.1)
        # 12 submitted, per-chip cap 2 over 4 chips: exactly 8 launched
        assert sum(d.chip_dispatches) == 8
        assert d.chip_inflight_high_water == [2, 2, 2, 2]
        assert d.inflight_high_water <= 8
        gate.set()
        for t in threads:
            t.join(timeout=30)
        counted = {c: obs.CHIP_DISPATCHES.labels(chip=str(c)).value
                   - before[c] for c in range(4)}
        assert sum(counted.values()) == sum(d.chip_dispatches) == 12
        assert list(counted.values()) == d.chip_dispatches
        assert results == {v: 8 * 8 * 3 * v for v in range(1, 13)}
    finally:
        gate.set()
        d.stop()


def test_completer_fault_on_one_chip_isolates_to_its_frames():
    """An injected completion failure fails only the faulted dispatch's
    frames; the dispatches in flight on the other chips answer and the
    completer never restarts."""
    gate = threading.Event()
    d = BatchDispatcher(_SumAnalyzer(gate), window_ms=1.0, max_batch=1,
                        max_inflight=1, device="cpu", router=_router(4))
    try:
        results: dict = {}
        threads = _gated_burst(d, (1, 2, 3, 4), results)
        assert _wait(lambda: sum(d.chip_dispatches) >= 4)
        assert d.chip_dispatches == [1, 1, 1, 1]
        configure_faults("serving.batch.complete:exc:1")
        gate.set()
        for t in threads:
            t.join(timeout=30)
        errs = [v for v, o in results.items() if isinstance(o, BaseException)]
        assert len(errs) == 1
        for v in (1, 2, 3, 4):
            if v not in errs:
                assert results[v] == 8 * 8 * 3 * v
        assert d.completer_restarts == 0
        assert _value(d.submit(_frame(9), _DEPTH, _K, 0.001)) == 8 * 8 * 3 * 9
    finally:
        gate.set()
        d.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_collector_death_with_multichip_inflight_resets_every_window():
    """The collector dies with dispatches gated in flight on several
    chips: the watchdog fails everything, rebuilds every chip's window,
    and the restarted pipeline serves on all chips again."""
    gate = threading.Event()
    d = BatchDispatcher(_SumAnalyzer(gate), window_ms=1.0, max_batch=1,
                        max_inflight=1, device="cpu", router=_router(4),
                        watchdog_interval_s=0.05)
    try:
        results: dict = {}
        inflight = _gated_burst(d, (1, 2, 3), results)
        assert _wait(lambda: sum(d.chip_dispatches) >= 3)
        assert sum(1 for c in d.chip_dispatches if c) >= 3
        configure_faults("serving.batch.collect:exc:1")
        trigger = _gated_burst(d, (4,), results)
        for t in inflight + trigger:
            t.join(timeout=30)
        errors = [results[v] for v in (1, 2, 3, 4)]
        assert all(isinstance(e, RuntimeError) and "collector died" in str(e)
                   for e in errors), errors
        assert d.collector_restarts == 1
        gate.set()
        # fresh windows on every chip: 4 new gated submits launch at once
        gate2 = threading.Event()
        d._analyze = _SumAnalyzer(gate2)
        threads = _gated_burst(d, (5, 6, 7, 8), results)
        assert _wait(lambda: sum(d.chip_dispatches) >= 7)
        assert sum(d.chip_dispatches) == 7
        gate2.set()
        for t in threads:
            t.join(timeout=30)
        assert [results[v] for v in (5, 6, 7, 8)] == [
            8 * 8 * 3 * v for v in (5, 6, 7, 8)]
    finally:
        gate.set()
        d.stop()


# -- data-sharded routing ------------------------------------------------------


def test_sharded_dispatch_splits_bucket_over_data_axis():
    per_chip = [_SumAnalyzer() for _ in range(4)]
    d = BatchDispatcher(per_chip[0], window_ms=5.0, max_batch=4,
                        max_inflight=2, device="cpu",
                        router=_router(4, "sharded", analyzers=per_chip))
    jd = jbatching.BatchDispatcher(_jax_sum(), window_ms=5.0, max_batch=4,
                                   max_inflight=2,
                                   router=_jrouter(4, "sharded"))
    try:
        for n in (1, 3, 4):  # the floor rises to the mesh width
            assert d.bucket_for(n) == jd.bucket_for(n) == 4
        got = {}
        for pkg, disp in (("port", d), ("jax", jd)):
            results: dict = {}
            for t in _gated_burst(disp, range(1, 5), results):
                t.join(timeout=30)
            got[pkg] = results
        assert got["port"] == got["jax"] == {
            v: 8 * 8 * 3 * v for v in range(1, 5)}
        # every dispatch spanned all four positions, one row block each
        calls = [a.calls for a in per_chip]
        assert all(c == calls[0] for c in calls) and calls[0]
        assert sum(d.dispatch_sizes.values()) == len(calls[0])
    finally:
        d.stop()
        jd.stop()


# -- serial-mode parity on a one-device mesh -----------------------------------


def _real_analyzer():
    """The port's batched analyzer (dense, packed) around a tiny forward,
    on the CPU: a fresh graph cache per call."""
    return tpipe.make_batch_analyzer(lambda x: (x[..., :1] - 0.45) * 20.0,
                                     img_size=16, device="cpu", pack=True)


def test_serial_mode_bitwise_parity_on_one_device_mesh():
    """max_inflight=1 on a one-position ring gives the router-less serial
    dispatcher's packed rows bit for bit; so do four positions, each on
    its own analyzer, and the sharded layout over two."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
              for _ in range(6)]
    depths = [rng.integers(0, 2000, (8, 8), dtype=np.uint16)
              for _ in range(6)]

    def run(router, analyzer):
        d = BatchDispatcher(analyzer, window_ms=1.0, max_batch=2,
                            max_inflight=1, router=router, device="cpu",
                            watchdog_interval_s=0.0)
        out = []
        try:
            for f, dep in zip(frames, depths):
                r = d.submit(f, dep, _K, 0.001, timeout_s=30.0)
                out.append(np.array(r.payload))
                r.release()
        finally:
            d.stop()
        return out

    plain = run(None, _real_analyzer())
    per4 = [_real_analyzer() for _ in range(4)]
    per2 = [_real_analyzer() for _ in range(2)]
    for routed in (run(_router(1), _real_analyzer()),
                   run(_router(4, analyzers=per4), per4[0]),
                   run(_router(2, "sharded", analyzers=per2), per2[0])):
        for a, b in zip(plain, routed):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)  # bitwise


# -- quarantine and failover ---------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_quarantined_chip_fails_over_and_is_reinstated():
    """A fault on position 1 opens its breaker: the position is
    quarantined (health NOT_SERVING), its frames fail over and answer, and
    after the reset time one probe dispatch reinstates it."""
    clock, flips = _Clock(), []
    router = _router(2, breaker_failures=2, breaker_reset_s=5.0,
                     clock=clock, on_health=lambda c, ok: flips.append(
                         (c, ok)))
    per_chip = [_SumAnalyzer(), _SumAnalyzer()]
    router.analyzers = per_chip
    d = BatchDispatcher(per_chip[0], window_ms=0.5, max_batch=1,
                        max_inflight=1, device="cpu", router=router,
                        watchdog_interval_s=0.0)
    try:
        configure_faults("serving.chip.1.dispatch:exc:-1")
        answers = [_value(d.submit(_frame(v), _DEPTH, _K, 0.001,
                                   timeout_s=30.0)) for v in range(1, 9)]
        assert answers == [8 * 8 * 3 * v for v in range(1, 9)]
        assert router.quarantined == frozenset({1})
        assert flips == [(1, False)]
        configure_faults(None)
        clock.t += 6.0  # past the reset: the next pick is the probe
        assert _value(d.submit(_frame(9), _DEPTH, _K, 0.001)) == 8 * 8 * 3 * 9
        assert _wait(lambda: not router.quarantined)
        assert flips == [(1, False), (1, True)]
        assert per_chip[1].calls  # the probe ran on position 1
    finally:
        configure_faults(None)
        d.stop()


# -- the controller's mode switch ----------------------------------------------


class _FakeDispatcher:
    def __init__(self, router):
        self.router = router
        self.recent_batch = 0.0


@pytest.mark.parametrize("chips", [2, 4])
def test_tune_mode_flips_as_the_jax_controller(chips):
    """The same occupancy sequence through both controllers' _tune_mode:
    full-ring buckets switch to sharded, half-ring or below back."""
    seq = [1.0, float(chips), float(chips), chips * 0.75, chips / 2, 1.0,
           float(chips), 0.5]
    routers = {
        "port": DeviceRouter([CPU] * chips, analyzers=[len] * chips,
                             sharded_analyzer=max),
        "jax": jbatching.DeviceRouter(jmesh.make_serving_mesh(chips),
                                      analyzers=[len] * chips,
                                      sharded_analyzer=max),
    }
    ctls = {"port": controller.ReactiveController(dispatcher=lambda: None,
                                                  burn=lambda: 0.0),
            "jax": jcontroller.ReactiveController(dispatcher=lambda: None,
                                                  burn=lambda: 0.0)}
    trace = {}
    for pkg in ("port", "jax"):
        fake = _FakeDispatcher(routers[pkg])
        steps = []
        for occupancy in seq:
            fake.recent_batch = occupancy
            steps.append((ctls[pkg]._tune_mode(fake), fake.router.mode))
        trace[pkg] = steps
    assert trace["port"] == trace["jax"]
    assert ("mode_sharded", "sharded") in trace["port"]
    assert ("mode_round_robin", "round_robin") in trace["port"]
    # a router that cannot switch is left alone
    fixed = _FakeDispatcher(DeviceRouter([CPU] * chips))
    fixed.recent_batch = float(chips)
    assert ctls["port"]._tune_mode(fixed) is None


def test_tune_mode_leaves_sharded_on_two_chips_under_the_real_average():
    """One-frame dispatches through a sharded two-position ring: the
    dispatcher's own average of them falls below the port's bar (half the
    ring plus ``MODE_BACK_SLACK``) within 10 frames of a full ring, and
    the controller switches back to round_robin; the same average never
    reaches the JAX rule's bar of 1.0, so the JAX controller stays
    sharded (the port's stated divergence)."""
    per = [_SumAnalyzer(), _SumAnalyzer()]
    router = _router(2, analyzers=per,
                     sharded_analyzer=batching.ShardedAnalyzer(per))
    d = BatchDispatcher(per[0], window_ms=1.0, max_batch=4, device="cpu",
                        router=router, watchdog_interval_s=0.0)
    ctl = controller.ReactiveController(dispatcher=lambda: d,
                                        burn=lambda: 0.0)
    try:
        router.set_mode("sharded")
        d.recent_batch = 2.0  # a full ring's dispatches
        back, n = None, 0
        while back is None and n < 50:
            assert _value(d.submit(_frame(n + 1), _DEPTH, _K, 0.001,
                                   timeout_s=30.0)) == 8 * 8 * 3 * (n + 1)
            back, n = ctl._tune_mode(d), n + 1
        assert back == "mode_round_robin" and router.mode == "round_robin"
        assert n == 10
        router.set_mode("sharded")
        for v in range(200):
            d.submit(_frame(v), _DEPTH, _K, 0.001, timeout_s=30.0)
        assert 1.0 < d.recent_batch < 1.0 + 1e-12  # settled above 1.0
        jrouter = jbatching.DeviceRouter(jmesh.make_serving_mesh(2),
                                         analyzers=[len, len],
                                         sharded_analyzer=max)
        jrouter.set_mode("sharded")
        fake = _FakeDispatcher(jrouter)
        fake.recent_batch = d.recent_batch
        jctl = jcontroller.ReactiveController(dispatcher=lambda: None,
                                              burn=lambda: 0.0)
        assert jctl._tune_mode(fake) is None and jrouter.mode == "sharded"
    finally:
        d.stop()


def test_dispatcher_tracks_recent_batch_for_the_controller():
    d = BatchDispatcher(_SumAnalyzer(), window_ms=20.0, max_batch=4,
                        device="cpu", router=_router(2),
                        watchdog_interval_s=0.0)
    try:
        results: dict = {}
        for t in _gated_burst(d, range(1, 5), results):
            t.join(timeout=30)
        assert 0.0 < d.recent_batch <= 4.0
    finally:
        d.stop()


# -- staging-buffer pool cap ---------------------------------------------------


def test_pool_put_caps_free_buffers_per_key():
    d = BatchDispatcher(_SumAnalyzer(), window_ms=1.0, max_batch=4,
                        max_inflight=2, device="cpu", router=_router(4),
                        watchdog_interval_s=0.0)
    try:
        cap = d._pool_cap
        assert cap == 2 * 4 + 1  # max_inflight * chips + 1
        p = batching._Pending(_frame(1), _DEPTH, _K, 0.001)
        key = (4, 8, 8)
        for _ in range(cap + 5):
            d._pool_put(batching._BucketBuffers(key, p, 4, pin=False))
        assert len(d._pool[key]) == cap  # extras dropped, not pooled
        assert obs.BATCH_POOL_SIZE.value == cap
        d._pool_take(4, p)
        assert obs.BATCH_POOL_SIZE.value == cap - 1
    finally:
        d.stop()


def test_legacy_dispatcher_pool_cap_and_gauge():
    d = BatchDispatcher(_SumAnalyzer(), window_ms=1.0, max_batch=4,
                        max_inflight=2, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        assert d._pool_cap == 2 * 1 + 1
        assert d.router is None and len(d.chip_dispatches) == 1
    finally:
        d.stop()


# -- the servicer's serving mesh and the config --------------------------------


def _service(tmp_path, **kw):
    cfg = config.ServerConfig(batch_window_ms=2.0, max_batch=2,
                              model_img_size=16,
                              metrics_csv=str(tmp_path / "m.csv"), **kw)
    return VisionAnalysisService(lambda x: (x[..., :1] - 0.45) * 20.0,
                                 cfg=cfg, device="cpu")


@pytest.mark.parametrize("mode", ["round_robin", "sharded"])
def test_servicer_routes_over_its_serving_mesh(tmp_path, mode):
    """``serving_mesh=2`` builds a two-position ring (its own analyzers,
    health entries, stats), and its answers equal the router-less
    server's bit for bit; ``serving_mesh=-1`` over one device builds none."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
              for _ in range(4)]
    depth = rng.integers(0, 2000, (24, 32), dtype=np.uint16)

    def answers(service):
        try:
            rows = []
            for f in frames:
                r = service.analyze_frame(f, depth)
                rows.append((r.mean_k, r.max_k, r.mask_bytes, r.coverage))
            return rows
        finally:
            service.close()

    plain = answers(_service(tmp_path))
    routed = _service(tmp_path, serving_mesh=2, dispatch_mode=mode,
                      controller_enabled=True)
    r = routed.dispatcher.router
    assert routed.serving_chips == 2 and r.chips == 2 and r.mode == mode
    assert r.can_switch_modes  # a controller-enabled ring binds both
    assert len(r.analyzers or []) == (2 if mode == "round_robin" else 0)
    assert routed.replica_stats()["chips"] == 2
    assert routed.replica_stats()["quarantined_chips"] == 0
    for i in range(2):
        assert routed.health.get(f"rdp.serving.chip.{i}") == health.NOT_SERVING
    assert answers(routed) == plain
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tmesh, "available_devices",
                  lambda device_type="cuda": [CPU])
        one = _service(tmp_path, serving_mesh=-1)
        try:
            assert one.serving_chips == 1 and one.dispatcher.router is None
        finally:
            one.close()


def test_router_config_keys_and_env_vars(monkeypatch):
    """The router's three ServerConfig keys with the JAX package's
    defaults, taken by from_dict and the flags; the two environment
    overrides resolve as the JAX package's."""
    keys = ("dispatch_mode", "chip_breaker_failures", "chip_breaker_reset_s")
    port, jax_ = config.ServerConfig(), jconfig.ServerConfig()
    assert {k: getattr(port, k) for k in keys} == {
        k: getattr(jax_, k) for k in keys}
    assert len(dataclasses.fields(config.ServerConfig)) == len(
        dataclasses.fields(jconfig.ServerConfig)) == 85
    made = config.from_dict(config.ServerConfig, {
        "dispatch_mode": "sharded", "chip_breaker_failures": 5,
        "chip_breaker_reset_s": 2.5, "serving_mesh": -1})
    assert (made.dispatch_mode, made.chip_breaker_failures,
            made.chip_breaker_reset_s, made.serving_mesh) == (
                "sharded", 5, 2.5, -1)
    parsed = config.parse_config(["--server.dispatch_mode", "sharded",
                                  "--server.serving_mesh", "2"])
    assert (parsed.server.dispatch_mode, parsed.server.serving_mesh) == (
        "sharded", 2)
    monkeypatch.setenv("RDP_SERVING_CHIPS", "2")
    monkeypatch.setenv("RDP_DISPATCH_MODE", "sharded")
    assert batching.resolve_serving_chips(0) == 2
    assert batching.resolve_dispatch_mode("round_robin") == "sharded"
    config.check_supported(dataclasses.replace(port, batch_window_ms=2.0))


def test_forward_on_another_position_is_the_same_function():
    """A ring position on another device gets a copy of the served
    forward moved there (``serving/server.forward_on``): the folded
    forward's twin and a module's copy compute the same logits, and a
    position on the forward's own device gets the forward itself."""
    from robotic_discovery_platform_tpu_torch.models.unet import UNet
    from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
    from robotic_discovery_platform_tpu_torch.serving.server import forward_on

    cfg = config.ModelConfig(base_features=4, compute_dtype="float32")
    net = UNet(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    folded = FoldedUNet(net, device="cpu")
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    assert forward_on(folded, CPU) is folded
    assert forward_on(net, CPU) is net
    twin = folded.on(CPU)
    assert twin is not folded and twin.device == CPU
    assert torch.equal(twin(x), folded(x))
    moved = forward_on(net, torch.device("meta"))
    assert moved is not net
    assert next(moved.parameters()).device.type == "meta"
    assert next(net.parameters()).device == CPU  # the original stays


@pytest.mark.parametrize("mode", ["shared", "dedicated"])
def test_zoo_placer_takes_several_chips_and_the_dispatcher_keeps_to_it(mode):
    """The port's ``ZooPlacer`` over more than one chip places the models
    as the JAX one does, and a routed dispatcher launches each model's
    frames on its placed positions only."""
    from robotic_discovery_platform_tpu.serving import zoo as jzoo
    from robotic_discovery_platform_tpu_torch.serving import zoo as tzoo

    models = ("seg", "aux")
    placers = {lib: lib.ZooPlacer(models, chips=2, mode=mode)
               for lib in (tzoo, jzoo)}
    for m in models:
        assert (placers[tzoo].chips_for(m) == placers[jzoo].chips_for(m))
    placer = placers[tzoo]
    per_chip = [_SumAnalyzer(), _SumAnalyzer()]
    aux_chip = [_SumAnalyzer(), _SumAnalyzer()]
    d = BatchDispatcher(per_chip[0], window_ms=0.5, max_batch=1,
                        max_inflight=1, device="cpu", placer=placer,
                        model_label="seg",
                        router=_router(2, analyzers=per_chip))
    d.bind_model("aux", aux_chip[0], per_chip_analyzers=aux_chip)
    try:
        for v in range(1, 5):
            assert _value(d.submit(_frame(v), _DEPTH, _K, 0.001,
                                   model="aux")) == 8 * 8 * 3 * v
        used = {i for i, a in enumerate(aux_chip) if a.calls}
        assert used <= set(placer.chips_for("aux"))
        assert not any(a.calls for a in per_chip)
    finally:
        d.stop()
