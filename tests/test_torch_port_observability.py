"""The port's observability layer (``observability/``, ``utils/logging``,
``utils/lockcheck``: copies of the JAX package's) against the JAX package,
and the port's own ``torch.profiler`` backend of ``/debug/profile``.

The same operations through both packages give byte-equal Prometheus
exposition text, equal streaming-sketch and summary quantiles, equal SLO
burn, and equal journal records once their timestamps are set aside.

Tolerances: none. Exposition text is compared byte for byte; quantiles,
sketch state and burn come from the same float64 arithmetic in the same
order and are compared exactly.
"""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from robotic_discovery_platform_tpu.observability import exposition as jexpo
from robotic_discovery_platform_tpu.observability import instruments as jobs
from robotic_discovery_platform_tpu.observability import journal as jjournal
from robotic_discovery_platform_tpu.observability import registry as jreg
from robotic_discovery_platform_tpu.observability import sketch as jsketch
from robotic_discovery_platform_tpu.observability import slo as jslo
from robotic_discovery_platform_tpu.observability import trace as jtrace
from robotic_discovery_platform_tpu.utils import lockcheck as jlockcheck
from robotic_discovery_platform_tpu_torch.observability import (
    exposition as texpo,
)
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as tobs,
)
from robotic_discovery_platform_tpu_torch.observability import (
    journal as tjournal,
)
from robotic_discovery_platform_tpu_torch.observability import registry as treg
from robotic_discovery_platform_tpu_torch.observability import sketch as tsketch
from robotic_discovery_platform_tpu_torch.observability import slo as tslo
from robotic_discovery_platform_tpu_torch.observability import trace as ttrace
from robotic_discovery_platform_tpu_torch.ops import graphs
from robotic_discovery_platform_tpu_torch.utils import lockcheck as tlockcheck
from robotic_discovery_platform_tpu_torch.utils import profiling
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger


def _values(seed: int, n: int) -> np.ndarray:
    """Latency-like values (seconds) with a tail, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-4.0, 0.6, n),
                           rng.uniform(0.0, 2.0, n // 10)])


def _drive(reg_module, seed: int) -> str:
    """One script of operations on a fresh registry; its exposition."""
    reg = reg_module.MetricsRegistry()
    frames = reg.counter("rdp_test_frames_total", 'Frames by "status"\n'
                         "and model.", ("status", "model"))
    inflight = reg.gauge("rdp_test_inflight", "Open streams.")
    stage = reg.histogram("rdp_test_stage_seconds", "Stage latency.",
                          ("stage",))
    summary = reg.summary("rdp_test_summary_seconds", "Streaming quantiles.",
                          ("stage",))
    rng = np.random.default_rng(seed)
    for i, v in enumerate(_values(seed, 300)):
        status = ("ok", "degraded", "error")[int(rng.integers(3))]
        frames.labels(status=status, model="seg").inc()
        stg = ("decode", "device", "encode")[i % 3]
        stage.labels(stage=stg).observe(float(v))
        summary.labels(stage=stg).observe(float(v))
        inflight.inc() if i % 4 else inflight.dec()
    frames.labels(status='we"ird\\', model="x\ny").inc(2.5)
    return reg_module, reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_equal_to_the_jax_package(seed):
    _, treg_ = _drive(treg, seed)
    _, jreg_ = _drive(jreg, seed)
    got, want = texpo.render(treg_), jexpo.render(jreg_)
    assert got == want
    assert 'status="we\\"ird\\\\"' in got and "# TYPE" in got


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 0.999])
def test_summary_quantiles_match_the_jax_package(q):
    """The port's P^2 update (unrolled) keeps every marker height,
    position and desired position of the JAX package's, bit for bit: on
    latencies, and on values with ties and runs below and above every
    marker."""
    rng = np.random.default_rng(7)
    ties = np.concatenate([np.full(50, 3.0), rng.integers(0, 5, 2000),
                           -np.arange(50.0), np.arange(50.0) + 10.0])
    for values in (_values(0, 2000), _values(3, 2000), ties):
        t = treg.P2Quantile(q)
        j = jreg.P2Quantile(q)
        for v in values:
            t.observe(float(v))
            j.observe(float(v))
        assert t.value == j.value and t.count == j.count
        assert (t._heights, t._pos, t._want) == (j._heights, j._pos,
                                                  j._want)


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 1.0, 32), (-5.0, 5.0, 7)])
def test_sketch_matches_the_jax_package(lo, hi, bins):
    values = list(_values(4, 500)) + [float("nan"), -10.0, 10.0]
    t, j = tsketch.StreamingSketch(lo, hi, bins), jsketch.StreamingSketch(
        lo, hi, bins)
    t.observe_many(values)
    j.observe_many(values)
    assert t.snapshot() == j.snapshot()
    assert (t.mean, t.variance, t.counts(), t.probabilities(),
            t.non_finite) == (j.mean, j.variance, j.counts(),
                              j.probabilities(), j.non_finite)
    merged_t = t.merge(tsketch.StreamingSketch.restore(t.snapshot()))
    merged_j = j.merge(jsketch.StreamingSketch.restore(j.snapshot()))
    assert merged_t.snapshot() == merged_j.snapshot()


@pytest.mark.parametrize("objective_ms,budget,window", [
    (20.0, 0.01, 512), (5.0, 0.1, 64), (100.0, 0.5, 8)])
def test_slo_burn_matches_the_jax_package(objective_ms, budget, window):
    values = _values(5, 400)
    rng = np.random.default_rng(6)
    oks = rng.random(len(values)) > 0.02
    t = tslo.SloTracker(objective_ms / 1e3, budget=budget, window=window)
    j = jslo.SloTracker(objective_ms / 1e3, budget=budget, window=window)
    for v, ok in zip(values, oks):
        assert t.observe(float(v), ok=bool(ok)) == j.observe(float(v),
                                                              ok=bool(ok))
        assert t.burn == j.burn
    assert (t.violations_total, t.observed_total, t.violation_rate) == (
        j.violations_total, j.observed_total, j.violation_rate)


@pytest.mark.parametrize("raw,want", [("", None), ("0", None), ("25", 25.0)])
def test_slo_objective_resolves_as_in_the_jax_package(raw, want,
                                                      monkeypatch):
    monkeypatch.setenv("RDP_SLO_MS", raw)
    assert tslo.resolve_slo_ms(0.0) == jslo.resolve_slo_ms(0.0) == want


def _journal_records(journal_module, trace_module):
    journal = journal_module.EventJournal(capacity=4)
    journal.append("server.ready", version="1")
    with trace_module.span("serving.stream"):
        journal.append("breaker.transition", "opened", breaker="registry",
                       frm="closed", to="open")
    for i in range(4):
        journal.append("server.drain", streams=str(i))
    snap = journal.snapshot(since=1)
    for e in snap["events"]:
        assert isinstance(e.pop("unix_ts"), float)
        e["trace_id"] = e["trace_id"] is not None
    snap.pop("host")
    return snap


def test_journal_records_match_the_jax_package():
    got = _journal_records(tjournal, ttrace)
    want = _journal_records(jjournal, jtrace)
    assert got == want
    assert got["dropped"] == 1 and got["next_cursor"] == 6


def test_trace_context_round_trips_as_in_the_jax_package():
    with ttrace.span("client") as sp:
        md = ttrace.to_metadata(sp.context)
    assert jtrace.from_metadata(md).traceparent() == sp.context.traceparent()
    with jtrace.span("client") as jsp:
        jmd = jtrace.to_metadata(jsp.context)
    assert ttrace.from_metadata(jmd) == ttrace.parse_traceparent(
        jsp.context.traceparent())
    assert ttrace.from_metadata([("other", "x")]) is None


def test_log_records_carry_the_span_trace_id(caplog, monkeypatch):
    """The port's record factory stamps its span's trace ID, "-" outside
    any span, and leaves the stamp of a factory installed before it (the
    JAX package's, in a process that loads both) when it has no span."""
    log = get_logger("rdp.port.test")
    prev = logging.getLogRecordFactory()

    def stamped(*args, **kwargs):
        record = logging.LogRecord(*args, **kwargs)
        record.trace_id = "earlier"
        return record

    messages = {}
    try:
        for inner in (logging.LogRecord, stamped):
            logging.setLogRecordFactory(inner)
            monkeypatch.setattr(ttrace, "_factory_installed", False)
            ttrace.install_log_correlation()
            caplog.clear()
            with caplog.at_level(logging.INFO):
                log.info("outside")
                with ttrace.span("serving.stream") as sp:
                    log.info("inside")
            messages[inner] = ({r.message: r.trace_id for r in caplog.records
                                if r.name == "rdp.port.test"},
                               sp.context.trace_id)
    finally:
        logging.setLogRecordFactory(prev)
    got, trace_id = messages[logging.LogRecord]
    assert got == {"outside": "-", "inside": trace_id}
    got, trace_id = messages[stamped]
    assert got == {"outside": "earlier", "inside": trace_id}


def test_instrument_families_are_the_jax_packages():
    """Every family the port defines is the JAX package's, with the same
    kind and labels (the rdp_* surface dashboards read)."""
    jax_families = {m.name: m for m in jobs.REGISTRY.collect()}
    ported = tobs.REGISTRY.collect()
    assert len(ported) >= 20
    for metric in ported:
        want = jax_families[metric.name]
        assert (metric.kind, metric.labelnames) == (want.kind,
                                                    want.labelnames)


@pytest.mark.parametrize("mode", ["strict", "warn"])
def test_lock_order_inversion_is_caught_as_in_the_jax_package(mode,
                                                               monkeypatch):
    monkeypatch.setenv("RDP_LOCKCHECK", mode)
    outcomes = []
    for module in (tlockcheck, jlockcheck):
        module.reset()
        a, b = module.checked_lock("test.a"), module.checked_lock("test.b")
        with a:
            with b:
                pass
        try:
            with b:
                with a:
                    pass
            outcomes.append(("ok", len(module.violations())))
        except module.LockOrderInversion:
            outcomes.append(("raised", len(module.violations())))
        module.reset()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("raised" if mode == "strict" else "ok")


# -- the metrics endpoint and /debug/profile ----------------------------------


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


@pytest.fixture()
def endpoint(tmp_path):
    reg = treg.MetricsRegistry()
    reg.counter("rdp_test_total", "A counter.").inc(3)
    journal = tjournal.EventJournal()
    journal.append("server.ready", version="7")
    server = texpo.MetricsServer(0, reg, host="localhost",
                                 profile_dir=str(tmp_path / "profiles"),
                                 journal=journal).start()
    yield server, reg
    server.stop()


@pytest.mark.parametrize("path", ["/metrics", "/debug/events",
                                  "/debug/spans", "/debug/tracez",
                                  "/debug/drift", "/debug/zoo",
                                  "/debug/rollout", "/federate",
                                  "/debug/trace?id=abc", "/nope"])
def test_endpoint_pages(endpoint, path):
    server, reg = endpoint
    status, body = _get(server.port, path)
    if path == "/metrics":
        assert status == 200 and body.decode() == texpo.render(reg)
    elif path == "/debug/events":
        events = json.loads(body)["events"]
        assert [(e["kind"], e["attrs"]) for e in events] == [
            ("server.ready", {"version": "7"})]
    elif path in ("/debug/spans", "/debug/tracez"):
        assert status == 200 and isinstance(json.loads(body), dict)
    elif path in ("/debug/drift", "/debug/zoo", "/debug/rollout"):
        # no provider attached: answered as the JAX endpoint answers
        assert status == 200 and json.loads(body)["enabled"] is False
    elif path in ("/federate", "/debug/trace?id=abc"):
        assert status == 404 and json.loads(body)["enabled"] is False
    else:
        assert status == 404


def test_profile_endpoint_writes_a_chrome_trace(endpoint):
    server, _ = endpoint
    status, body = _get(server.port, "/debug/profile?seconds=0.2")
    assert status == 200, body
    reply = json.loads(body)
    assert reply["seconds"] == 0.2 and reply["files"] == 1
    trace_file = os.path.join(reply["profile_dir"], profiling.TRACE_FILE)
    events = json.load(open(trace_file))["traceEvents"]
    assert any("square" in str(e.get("name", "")) for e in events)
    assert _get(server.port, "/debug/profile?seconds=x")[0] == 400


def test_profile_endpoint_refuses_without_a_directory(monkeypatch):
    monkeypatch.delenv("RDP_PROFILE_DIR", raising=False)
    server = texpo.MetricsServer(0, treg.MetricsRegistry(),
                                 host="localhost").start()
    try:
        assert _get(server.port, "/debug/profile")[0] == 409
    finally:
        server.stop()


def test_one_profile_at_a_time(tmp_path, endpoint):
    server, _ = endpoint
    done = {}
    first = threading.Thread(target=lambda: done.setdefault(
        "dir", profiling.capture_profile(str(tmp_path), 1.0)))
    first.start()
    deadline = time.monotonic() + 30
    while not profiling._capture_lock.locked():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="already in progress"):
        profiling.capture_profile(str(tmp_path), 0.1)
    status, body = _get(server.port, "/debug/profile?seconds=0.1")
    assert status == 409 and b"already in progress" in body
    first.join(timeout=60)
    assert not first.is_alive() and os.path.isdir(done["dir"])


def test_profiler_starts_only_outside_a_capture():
    """``graphs.no_capture`` (the profiler's start and stop) waits for the
    capture in progress, and a capture waits while it is held."""
    order = []
    release = threading.Event()

    def capture():
        with graphs._capture_lock:  # what Capture holds around a capture
            order.append("capture in")
            release.wait(10)
            order.append("capture out")

    t = threading.Thread(target=capture)
    t.start()
    while not order:
        time.sleep(0.001)

    def profiler_start():
        with graphs.no_capture():
            order.append("profiler")

    p = threading.Thread(target=profiler_start)
    p.start()
    time.sleep(0.1)
    assert order == ["capture in"]  # the profiler waits for the capture
    release.set()
    t.join(10)
    p.join(10)
    assert order == ["capture in", "capture out", "profiler"]
    with graphs.no_capture():
        late = threading.Thread(target=capture)
        late.start()
        time.sleep(0.1)
        assert order[-1] == "profiler"  # the capture waits for the gate
    late.join(10)
    assert order[-2:] == ["capture in", "capture out"]
