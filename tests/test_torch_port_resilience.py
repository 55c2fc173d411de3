"""The port's resilience layer (``resilience/``: a copy of the JAX
package's) against the JAX package: the same call sequences through both
packages' circuit breaker, retry policy, deadline and fault registry give
the same transitions, delays, raises and counts; and a servicer keeps
serving its current generation while the registry breaker is open, as
the JAX servicer does.

Tolerances: none. Breaker states, fault counts and exception types are
compared exactly; retry delays come from the same arithmetic on one
seeded ``random.Random`` and are compared exactly too.
"""

import itertools
import random

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import resilience as jres
from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.resilience import faults as jfaults
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import resilience as tres
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.resilience import faults as tfaults
from robotic_discovery_platform_tpu_torch.resilience import sites as tsites
from robotic_discovery_platform_tpu_torch.serving import ingest
from robotic_discovery_platform_tpu_torch.serving import server as tserver
from robotic_discovery_platform_tpu_torch.utils import config as tconfig

PACKAGES = {"jax": jres, "port": tres}
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
    """No fault spec leaks across tests, in either package."""
    yield
    jres.configure_faults(None)
    tres.configure_faults(None)


class FakeClock:
    """Time moves only when told to; sleeps are recorded."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.now += s


def _raise(exc):
    raise exc


# each step: ("fail" | "ok" | "advance", seconds) through breaker.call
BREAKER_SCRIPTS = {
    "opens_and_fast_fails": [("fail", 0)] * 3 + [("ok", 0), ("advance", 29.9),
                                                 ("ok", 0)],
    "half_open_probe_closes": [("fail", 0), ("advance", 10.0), ("ok", 0),
                               ("fail", 0)],
    "half_open_probe_reopens": [("fail", 0), ("advance", 10.0), ("fail", 0),
                                ("advance", 9.9), ("ok", 0),
                                ("advance", 0.2), ("ok", 0)],
    "success_resets_the_count": [("fail", 0), ("fail", 0), ("ok", 0),
                                 ("fail", 0), ("fail", 0), ("fail", 0),
                                 ("ok", 0)],
}


def _breaker_trace(pkg, script, threshold):
    clk = FakeClock()
    b = pkg.CircuitBreaker(failure_threshold=threshold, reset_timeout_s=10.0
                           if threshold == 1 else 30.0, clock=clk, name="t")
    out = []
    for step, arg in script:
        if step == "advance":
            clk.now += arg
            out.append(("state", b.state))
            continue
        fn = ((lambda: "ok") if step == "ok"
              else (lambda: _raise(ConnectionError("down"))))
        try:
            out.append(("ret", b.call(fn)))
        except pkg.CircuitOpenError as exc:
            out.append(("open", round(exc.retry_in_s, 6)))
        except ConnectionError:
            out.append(("raised", None))
        out.append((b.state, b.failure_count))
    return out


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_transitions_match_the_jax_package(script):
    threshold = 3 if script in ("opens_and_fast_fails",
                                "success_resets_the_count") else 1
    got = _breaker_trace(tres, BREAKER_SCRIPTS[script], threshold)
    want = _breaker_trace(jres, BREAKER_SCRIPTS[script], threshold)
    assert got == want
    assert any(s == "open" for s, _ in got if isinstance(s, str))


def test_breaker_half_open_admits_a_single_probe_in_both():
    for pkg in PACKAGES.values():
        clk = FakeClock()
        b = pkg.CircuitBreaker(failure_threshold=1, reset_timeout_s=1.0,
                               clock=clk)
        b.record_failure()
        clk.now += 1.0
        assert [b.allow(), b.allow()] == [True, False]
        b.record_success()
        assert b.allow() and b.state == "closed"


@pytest.mark.parametrize("seed,jitter", [(0, 0.0), (42, 0.25), (7, 0.5)])
def test_retry_delays_match_the_jax_package(seed, jitter):
    def schedule(pkg):
        p = pkg.RetryPolicy(base_delay_s=0.1, multiplier=2.0,
                            max_delay_s=1.0, jitter=jitter,
                            rng=random.Random(seed))
        return list(itertools.islice(p.delays(), 8))

    assert schedule(tres) == schedule(jres)


@pytest.mark.parametrize("outcome", ["recovers", "exhausts", "non_retryable",
                                     "deadline"])
def test_retry_calls_match_the_jax_package(outcome):
    def run(pkg):
        clk = FakeClock()
        policy = pkg.RetryPolicy(max_attempts=4, base_delay_s=0.1,
                                 multiplier=2.0, jitter=0.25, clock=clk,
                                 sleep=clk.sleep, rng=random.Random(3))
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if outcome == "non_retryable":
                raise ValueError("bug")
            if outcome == "recovers" and calls["n"] > 2:
                return "ok"
            raise ConnectionError("down")

        deadline = (pkg.Deadline.after(0.15, clock=clk)
                    if outcome == "deadline" else None)
        try:
            result = policy.call(fn, deadline=deadline)
        except (ConnectionError, ValueError) as exc:
            result = type(exc).__name__
        return result, calls["n"], clk.sleeps

    assert run(tres) == run(jres)


def test_deadline_matches_the_jax_package():
    for pkg in PACKAGES.values():
        clk = FakeClock()
        d = pkg.Deadline.after(5.0, clock=clk)
        clk.now = 4.0
        assert d.remaining() == pytest.approx(1.0) and not d.expired()
        d.check("resolve")
        clk.now = 6.0
        assert d.expired() and d.remaining() == 0.0
        with pytest.raises(pkg.DeadlineExceeded, match="resolve"):
            d.check("resolve")


@pytest.mark.parametrize("exc", [ConnectionError(), TimeoutError(),
                                 ValueError("bug"), RuntimeError("x"),
                                 "http500", "http404", "deadline"])
def test_default_retryable_matches_the_jax_package(exc):
    def make(pkg):
        if exc == "http500":
            return pkg.InjectedHTTPError("site", 500)
        if exc == "http404":
            return pkg.InjectedHTTPError("site", 404)
        if exc == "deadline":
            return pkg.DeadlineExceeded("budget")
        return exc

    assert (tres.default_retryable(make(tres))
            == jres.default_retryable(make(jres)))


FAULT_SPECS = [
    "a.b:conn:2, c.d:exc:1",
    "a.b:http500:1,a.b:http429:-1",
    "serving.chip.*.dispatch:exc:2,serving.chip.1.dispatch:conn:1",
    "x.y:slow:2",
    "a.b:exc:inf",
]


def _fault_trace(module, spec, sites):
    reg = module.FaultRegistry(spec)
    out = []
    for site in sites:
        try:
            reg.inject(site)
            out.append((site, None))
        except Exception as exc:  # noqa: BLE001 - the injected kind
            out.append((site, type(exc).__name__,
                        getattr(exc, "status", None)))
    return out, {s: reg.fired(s) for s in sorted(set(sites))}


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_parsing_and_firing_match_the_jax_package(spec, monkeypatch):
    monkeypatch.setenv("RDP_FAULT_SLOW_S", "0.001")
    sites = ["a.b", "c.d", "serving.chip.0.dispatch",
             "serving.chip.1.dispatch", "x.y", "none"] * 3
    assert _fault_trace(tfaults, spec, sites) == _fault_trace(
        jfaults, spec, sites)


@pytest.mark.parametrize("bad", ["nosuch", "a.b:boom:1", "a.b:conn:x",
                                 "a.b:conn"])
def test_bad_fault_specs_are_refused_by_both(bad):
    with pytest.raises(ValueError):
        jfaults.FaultRegistry(bad)
    with pytest.raises(ValueError):
        tfaults.FaultRegistry(bad)


def test_fault_sites_are_the_jax_packages():
    from robotic_discovery_platform_tpu.resilience import sites as jsites

    assert tsites.ALL_SITES == jsites.ALL_SITES
    assert tsites.SITE_PATTERNS == jsites.SITE_PATTERNS
    assert tsites.chip_dispatch(3) == jsites.chip_dispatch(3)


# -- a registry outage: the breaker opens and serving goes on ---------------------


SMALL = tconfig.ModelConfig(base_features=4, compute_dtype="float32")
SIZE = 32


def _register(uri):
    """Version 1 of NAME in a file store both packages read, as the
    ``staging`` alias."""
    net = tunet.UNet(SMALL).init_weights(torch.Generator().manual_seed(0))
    tracking.set_tracking_uri(uri)
    tracking.set_experiment("Actuator Segmentation")
    with tracking.start_run():
        version = tracking.log_model(weights.to_flax_variables(net), SMALL,
                                     registered_model_name=NAME)
    tracking.store_for(uri).set_alias(NAME, "staging", version)
    return version


def test_breaker_opens_on_a_registry_outage_and_serving_continues(tmp_path):
    """The counterpart of the JAX package's
    ``test_breaker_opens_on_sustained_outage_and_serving_continues``, with
    the outage forced at the resolve site of each package
    (``serving.resolve:exc:-1``): two failing polls open both breakers,
    further polls never reach the registry, and the port's servicer
    answers frames from its current generation."""
    uri = f"file:{tmp_path}/mlruns"
    v1 = _register(uri)
    common = dict(tracking_uri=uri, model_img_size=SIZE,
                  calibration_path=str(tmp_path / "none.npz"),
                  registry_breaker_failures=2,
                  registry_breaker_reset_s=300.0, reload_poll_s=0.0)
    service = tserver.build_service(
        tconfig.ServerConfig(metrics_csv=str(tmp_path / "p.csv"), **common),
        device="cpu")
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    try:
        model, variables, version = jserver.resolve_serving_model(
            jconfig.ServerConfig(tracking_uri=uri))
        jservice = jserver.VisionAnalysisService(
            model, variables, None, 0.001,
            jconfig.ServerConfig(metrics_csv=str(tmp_path / "j.csv"),
                                 **common), version=version)
    finally:
        jtracking.set_tracking_uri(prev)
    try:
        assert service.current_version == jservice.current_version == v1
        tres.configure_faults("serving.resolve:exc:-1")
        jres.configure_faults("serving.resolve:exc:-1")
        states = []
        for _ in range(5):
            states.append((service.maybe_reload(), jservice.maybe_reload(),
                           service.registry_breaker.state,
                           jservice.registry_breaker.state))
        assert states == [(False, False, "closed", "closed")] + [
            (False, False, "open", "open")] * 4
        # the open breakers never touched the registry again
        assert tres.fired("serving.resolve") == 2
        assert jres.fired("serving.resolve") == 2
        rgb, _, depth = render_scene(np.random.default_rng(0), 48, 64)
        out = list(service.analyze_stream(iter([ingest.raw_request(
            rgb, depth)] * 3)))
        assert len(out) == 3
        assert all(not r.status.startswith("ERROR") for r in out)
        assert service.current_version == v1
    finally:
        service.close()
        jservice.close()
