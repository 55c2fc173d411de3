"""The port's batch dispatcher (serving/batching.py) and admission queue
(serving/admission.py) on the CPU, with a fake analyzer, modelled on
tests/test_pipelined_dispatch.py: coalescing within the window, the
max_batch cap and bucket padding, load shedding at the backlog cap and
the submit deadline, a failing analyzer failing only its own group,
serial and overlapped windows giving the same results, the watchdog
restarting a dead stage, stop() leaving no submitter blocked, and the
admission queue deciding as the JAX package's does.

Tolerances, fixed before measuring: none. Every result is a packed row
whose values are compared exactly.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.serving import admission as jadm
from robotic_discovery_platform_tpu_torch.ops import geometry as tgeom
from robotic_discovery_platform_tpu_torch.ops import pipeline as tpipe
from robotic_discovery_platform_tpu_torch.serving import admission as tadm
from robotic_discovery_platform_tpu_torch.serving import batching
from robotic_discovery_platform_tpu_torch.serving.batching import (
    BatchDispatcher,
    DeadlineExceeded,
    OverloadedError,
)

_DEPTH = np.zeros((8, 8), np.uint16)
_K = np.eye(3, dtype=np.float32)
N_PTS = 2


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


def _frame(v: int, size: int = 8) -> np.ndarray:
    return np.full((size, size, 3), v, np.uint8)


def _pack(frames) -> torch.Tensor:
    """Packed rows whose coverage is each frame's first pixel: a submitter
    can tell its own frame's result."""
    f = np.asarray(frames)
    b = f.shape[0]
    zero = torch.zeros(b)
    prof = tgeom.CurvatureProfile(
        mean_curvature=zero, max_curvature=zero,
        spline_points=torch.zeros(b, N_PTS, 3),
        valid=torch.ones(b, dtype=torch.bool),
        num_cloud_points=torch.zeros(b, dtype=torch.int32),
        num_edge_points=torch.zeros(b, dtype=torch.int32),
        truncated=torch.zeros(b, dtype=torch.bool))
    out = tpipe.FrameAnalysis(
        mask=torch.from_numpy((f[..., 0] > 0).astype(np.uint8)),
        mask_coverage=torch.from_numpy(f[:, 0, 0, 0].astype(np.float32)),
        profile=prof, confidence_margin=zero)
    return tpipe.pack_analysis(out, n_pts=N_PTS)


class _Lazy:
    """A result whose host read blocks until ``gate`` opens: device work
    still in flight when the completer picks the dispatch up."""

    def __init__(self, rows: torch.Tensor, gate: threading.Event):
        self._rows, self._gate = rows, gate

    def __array__(self, dtype=None, copy=None):
        self._gate.wait(30.0)
        return np.asarray(self._rows.numpy(), dtype)


class _Analyzer:
    """Fake batched analyzer: records the padded batch each dispatch
    carried; optionally gated, optionally failing on a frame value."""

    def __init__(self, gate=None, fail_on=None):
        self.gate, self.fail_on = gate, fail_on
        self.batches: list[np.ndarray] = []

    def __call__(self, frames, depths, intr, scales):
        f = np.array(frames)
        self.batches.append(f[:, 0, 0, 0])
        if self.fail_on is not None and (f == self.fail_on).any():
            raise ValueError("bad frame in this group")
        rows = _pack(f)
        return rows if self.gate is None else _Lazy(rows, self.gate)


def _value(result) -> int:
    try:
        return int(result.scalars()[0])
    finally:
        result.release()


def _submit_all(d, values, results, timeout_s=30.0, size=8):
    def one(v):
        try:
            results[v] = _value(d.submit(_frame(v, size),
                                         np.zeros((size, size), np.uint16),
                                         _K, 0.001, timeout_s=timeout_s))
        except BaseException as exc:  # noqa: BLE001 - recorded for asserts
            results[v] = exc

    threads = [threading.Thread(target=one, args=(v,)) for v in values]
    for t in threads:
        t.start()
    return threads


def _wait_for(cond, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def test_coalesces_within_the_window_and_pads_the_bucket():
    fake = _Analyzer()
    d = BatchDispatcher(fake, window_ms=500.0, max_batch=4, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        results: dict = {}
        for t in _submit_all(d, (1, 2, 3), results):
            t.join(timeout=30)
        assert results == {1: 1, 2: 2, 3: 3}
        assert dict(d.dispatch_sizes) == {3: 1}  # one dispatch of 3
        (batch,) = fake.batches
        assert len(batch) == 4  # padded to the power-of-two bucket
        assert sorted(batch[:3]) == [1, 2, 3] and batch[3] == batch[0]
    finally:
        d.stop()


def test_max_batch_caps_a_dispatch():
    fake = _Analyzer()
    d = BatchDispatcher(fake, window_ms=300.0, max_batch=4, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        results: dict = {}
        for t in _submit_all(d, range(1, 7), results):
            t.join(timeout=30)
        assert results == {v: v for v in range(1, 7)}
        assert sum(n * k for n, k in d.dispatch_sizes.items()) == 6
        assert max(d.dispatch_sizes) == 4
        assert all(len(b) in (1, 2, 4) for b in fake.batches)
    finally:
        d.stop()


@pytest.mark.parametrize("b,n", [(1, 1), (2, 2), (4, 3), (8, 5), (8, 8)])
def test_bucket_and_staging_pad_rows(b, n):
    assert batching._bucket(n, 8) == b
    d = BatchDispatcher(_Analyzer(), device="cpu", watchdog_interval_s=0.0)
    try:
        group = [batching._Pending(_frame(v + 1), _DEPTH + v, _K * (v + 1),
                                   0.001 * (v + 1)) for v in range(n)]
        bufs = d._stage_group(group, b)
        assert bufs.frames.shape == (b, 8, 8, 3)
        frames, depths, intr, scales = (t.numpy() for t in (
            bufs.frames, bufs.depths, bufs.intr, bufs.scales))
        for i in range(b):
            src = group[i] if i < n else group[0]  # pads replicate frame 0
            np.testing.assert_array_equal(frames[i], src.frame_rgb)
            np.testing.assert_array_equal(depths[i].view(np.uint16),
                                          src.depth)
            np.testing.assert_array_equal(intr[i], src.intrinsics)
            assert scales[i] == np.float32(src.depth_scale)
        d._pool_put(bufs)
        assert d._stage_group(group, b) is bufs  # the pooled set, reused
    finally:
        d.stop()


def test_overloaded_at_the_backlog_cap_and_deadline():
    gate = threading.Event()
    d = BatchDispatcher(_Analyzer(gate), window_ms=0.0, max_batch=1,
                        max_backlog=2, max_inflight=1, admission="fifo",
                        device="cpu", watchdog_interval_s=0.0)
    try:
        results: dict = {}
        # frame 1 launches and waits in the completer; frame 2 waits for
        # the window's one slot; frames 3 and 4 fill the backlog
        threads = _submit_all(d, (1,), results)
        _wait_for(lambda: d.inflight_high_water == 1, "frame 1's launch")
        threads += _submit_all(d, (2,), results)
        _wait_for(lambda: d.backlog() == 0 and len(d._pending) == 2,
                  "frame 2 at the window")
        time.sleep(0.05)
        for v, queued in ((3, 1), (4, 2)):
            threads += _submit_all(d, (v,), results)
            _wait_for(lambda q=queued: d.backlog() == q, f"frame {v} queued")
        with pytest.raises(OverloadedError, match="backlog at cap"):
            d.submit(_frame(5), _DEPTH, _K, 0.001)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert results == {1: 1, 2: 2, 3: 3, 4: 4}
        gate.clear()
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="per-submit deadline"):
            d.submit(_frame(6), _DEPTH, _K, 0.001, timeout_s=0.2)
        assert time.monotonic() - t0 < 5.0
    finally:
        gate.set()
        d.stop()


def test_deadline_policy_evicts_the_least_headroom_frame():
    gate = threading.Event()
    d = BatchDispatcher(_Analyzer(gate), window_ms=0.0, max_batch=1,
                        max_backlog=1, max_inflight=1, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        results: dict = {}
        threads = _submit_all(d, (1,), results)
        _wait_for(lambda: d.inflight_high_water == 1, "frame 1's launch")
        threads += _submit_all(d, (2,), results)
        _wait_for(lambda: d.backlog() == 0 and len(d._pending) == 2,
                  "frame 2 at the window")
        time.sleep(0.05)
        threads += _submit_all(d, (3,), results, timeout_s=10.0)  # queued
        _wait_for(lambda: d.backlog() == 1, "frame 3 queued")
        threads += _submit_all(d, (4,), results, timeout_s=30.0)  # evicts 3
        _wait_for(lambda: 3 in results, "frame 3's eviction")
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert isinstance(results[3], OverloadedError)
        assert "evicted" in str(results[3])
        assert {v: results[v] for v in (1, 2, 4)} == {1: 1, 2: 2, 4: 4}
    finally:
        gate.set()
        d.stop()


def test_a_failing_analyzer_fails_only_its_group():
    fake = _Analyzer(fail_on=13)
    d = BatchDispatcher(fake, window_ms=300.0, max_batch=4, device="cpu",
                        watchdog_interval_s=0.0)
    try:
        results: dict = {}
        threads = _submit_all(d, (13,), results)  # 8 x 8: the bad group
        threads += _submit_all(d, (5,), results, size=16)  # another camera
        for t in threads:
            t.join(timeout=30)
        assert isinstance(results[13], ValueError)
        assert results[5] == 5
        assert _value(d.submit(_frame(7), _DEPTH, _K, 0.001)) == 7
    finally:
        d.stop()


class _Stream:
    """Stands in for the dispatch stream: records how many staging sets
    the pool held when the dispatcher waited on it."""

    def __init__(self, d, fail: bool):
        self.d, self.fail, self.pooled_at_sync = d, fail, []

    def synchronize(self):
        self.pooled_at_sync.append(sum(len(v) for v in self.d._pool.values()))
        if self.fail:
            raise RuntimeError("stream lost")


@pytest.mark.parametrize("stream_fails", [False, True])
def test_a_failed_dispatch_pools_its_staging_only_after_the_stream(
        stream_fails):
    d = BatchDispatcher(_Analyzer(fail_on=13), window_ms=1.0, max_batch=4,
                        device="cpu", watchdog_interval_s=0.0)
    try:
        d._streams[0] = _Stream(d, stream_fails)
        with pytest.raises(ValueError):
            d.submit(_frame(13), _DEPTH, _K, 0.001)
        _wait_for(lambda: d._streams[0].pooled_at_sync, "the stream wait")
        time.sleep(0.05)  # the set is pooled (or dropped) right after
        # waited before the failed set went back, and dropped it when the
        # stream could not say its copies were done
        assert d._streams[0].pooled_at_sync == [0]
        held = sum(len(v) for v in d._pool.values())
        assert held == (0 if stream_fails else 1)
    finally:
        d._streams[0] = None
        d.stop()


def _streams(d, n_streams: int = 4, frames: int = 5) -> dict:
    out: dict = {}

    def stream(sid):
        rows = []
        for i in range(frames):
            r = d.submit(_frame(10 * sid + i), _DEPTH, _K, 0.001)
            rows.append(r.payload.tobytes())
            r.release()
        out[sid] = rows

    threads = [threading.Thread(target=stream, args=(s,))
               for s in range(1, n_streams + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def test_serial_and_overlapped_windows_give_identical_results():
    results = {}
    for depth in (1, 2):
        d = BatchDispatcher(_Analyzer(), window_ms=2.0, max_batch=4,
                            max_inflight=depth, device="cpu")
        try:
            results[depth] = _streams(d)
            assert d.inflight_high_water <= depth
        finally:
            d.stop()
    assert results[1] == results[2]
    for sid, rows in results[1].items():
        for i, row in enumerate(rows):
            assert np.frombuffer(row, np.uint8).size > 0
            assert _value(batching.PackedResult(
                np.frombuffer(row, np.uint8))) == 10 * sid + i


def test_inflight_window_fills_and_overlaps():
    gate = threading.Event()
    d = BatchDispatcher(_Analyzer(gate), window_ms=1.0, max_batch=2,
                        max_inflight=2, device="cpu")
    try:
        results: dict = {}
        threads = _submit_all(d, range(1, 7), results)
        deadline = time.monotonic() + 10
        while d.inflight_high_water < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert results == {v: v for v in range(1, 7)}
        assert d.inflight_high_water == 2
        assert d.overlap_s_total > 0.0
    finally:
        gate.set()
        d.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_a_dead_collector():
    d = BatchDispatcher(_Analyzer(), window_ms=1.0, max_batch=2,
                        device="cpu", watchdog_interval_s=0.05)
    try:
        collect = d._collect

        def dies_once():
            d._collect = collect
            raise RuntimeError("collector bug")

        d._collect = dies_once
        # the collector is inside collect(); this frame brings it round to
        # the patched call, which kills the thread
        assert _value(d.submit(_frame(1), _DEPTH, _K, 0.001)) == 1
        with pytest.raises(RuntimeError, match="collector died"):
            d.submit(_frame(2), _DEPTH, _K, 0.001, timeout_s=30.0)
        assert d.collector_restarts == 1
        assert _value(d.submit(_frame(3), _DEPTH, _K, 0.001)) == 3
    finally:
        d.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_a_dead_completer():
    d = BatchDispatcher(_Analyzer(), window_ms=1.0, max_batch=4,
                        device="cpu", watchdog_interval_s=0.05)
    try:
        d._cq.put(object())  # not a dispatch: kills the completer
        deadline = time.monotonic() + 10
        while d.completer_restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert d.completer_restarts == 1
        assert _value(d.submit(_frame(4), _DEPTH, _K, 0.001)) == 4
    finally:
        d.stop()


def test_stop_with_frames_pending_leaves_no_submitter_blocked():
    gate = threading.Event()
    d = BatchDispatcher(_Analyzer(gate), window_ms=1.0, max_batch=1,
                        max_inflight=1, device="cpu")
    results: dict = {}
    threads = _submit_all(d, (1,), results)
    _wait_for(lambda: d.inflight_high_water == 1, "frame 1's launch")
    threads += _submit_all(d, (2,), results)
    _wait_for(lambda: d.backlog() == 0 and len(d._pending) == 2,
              "frame 2 at the window")
    for v, queued in ((3, 1), (4, 2)):
        threads += _submit_all(d, (v,), results)
        _wait_for(lambda q=queued: d.backlog() == q, f"frame {v} queued")
    stopper = threading.Thread(target=d.stop)
    stopper.start()
    time.sleep(0.2)
    gate.set()  # the launched dispatch completes with its real result
    stopper.join(timeout=30)
    for t in threads:
        t.join(timeout=30)
    assert results[1] == 1
    for v in (2, 3, 4):
        assert isinstance(results[v], RuntimeError), results[v]
        assert "dispatcher stopped" in str(results[v])
    with pytest.raises(RuntimeError, match="dispatcher stopped"):
        d.submit(_frame(5), _DEPTH, _K, 0.001)


def test_left_out_parts_raise():
    d = BatchDispatcher(_Analyzer(), device="cpu", watchdog_interval_s=0.0)
    try:
        # the coefficient lane is ported: a non-CoefficientFrame is refused
        with pytest.raises(TypeError, match="CoefficientFrame"):
            d.submit_coef(None, _DEPTH, _K, 0.001)
        # the zoo's bind_model is ported: the default model is bound at
        # construction, and an unbound model's frame is refused
        with pytest.raises(ValueError, match="bound at construction"):
            d.bind_model("", _Analyzer())
        with pytest.raises(ValueError, match="unknown model 'aux'"):
            d.submit(_frame(0), _DEPTH, _K, 0.001, model="aux")
    finally:
        d.stop()
    # the router is ported (tests/test_torch_port_mesh_routing.py): a
    # two-position ring routes, and a sharded ring's geometry is checked
    ring = [torch.device("cpu")] * 2
    d = BatchDispatcher(_Analyzer(), device="cpu", watchdog_interval_s=0.0,
                        router=batching.DeviceRouter(ring))
    try:
        assert d.router.chips == 2 and len(d.chip_dispatches) == 2
        assert _value(d.submit(_frame(3), _DEPTH, _K, 0.001)) == 3
    finally:
        d.stop()
    with pytest.raises(ValueError, match="multiple of the chip count"):
        BatchDispatcher(_Analyzer(), device="cpu", max_batch=1,
                        router=batching.DeviceRouter(ring, "sharded"))


class _Item:
    def __init__(self, name, deadline_t):
        self.name, self.deadline_t = name, deadline_t


@pytest.mark.parametrize("policy", ["deadline", "fifo"])
def test_admission_queue_decides_as_jax(policy):
    """The same sequence of puts, gets and requeues through both packages'
    DeadlineQueue under one fake clock: the same admissions, evictions,
    refusals and order out."""
    rng = np.random.default_rng(0 if policy == "deadline" else 1)
    ops = [("put", f"f{i}", float(rng.uniform(0.5, 5.0)),
            float(rng.uniform(0.0, 0.5))) for i in range(40)]
    for i in range(0, 40, 7):
        ops.insert(i, ("get",))
    ops.insert(20, ("requeue",))
    logs = []
    for mod in (jadm, tadm):
        now = [100.0]
        evicted: list = []
        q = mod.DeadlineQueue(3, policy=policy,
                              on_evict=lambda it: evicted.append(it.name),
                              clock=lambda: now[0])
        log, popped = [], []
        for op in ops:
            now[0] += 0.01
            if op[0] == "put":
                _, name, budget, margin = op
                try:
                    q.put(_Item(name, now[0] + budget), margin_s=margin)
                    log.append(("ok", name))
                except mod.OverloadedError:
                    log.append(("shed", name))
            elif op[0] == "get":
                try:
                    popped.append(q.get_nowait().name)
                    log.append(("got", popped[-1]))
                except queue.Empty:
                    log.append(("empty",))
            else:
                q.requeue([_Item(n, now[0] + 1.0) for n in popped[-2:]])
        while q.qsize():
            log.append(("got", q.get_nowait().name))
        logs.append((log, evicted, q.evictions))
    assert logs[0] == logs[1]
    assert (logs[0][2] > 0) == (policy == "deadline")

    est = [mod.ServiceTimeEstimator(window=4) for mod in (jadm, tadm)]
    for s in (0.3, 0.1, 0.2, 0.5, 0.4, -1.0):
        for e in est:
            e.observe(s, key=("", 4))
    assert [e.s_for("") for e in est] == [est[0].s, est[1].s]
    assert est[0].s_for("") == est[1].s_for("") == 0.1  # last 4 rides
