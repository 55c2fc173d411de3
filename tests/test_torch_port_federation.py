"""The port's fleet federation (observability/federation.py) and the
front-end's trace stitching (serving/frontend.py) against the JAX
package's, on the CPU.

- ``relabel`` and ``merge_exposition`` give byte-equal text for the same
  expositions (headers, histograms, escapes, samples before any header,
  label-less samples);
- ``FleetFederator.render`` over the same fake scrapes is byte-equal to
  the JAX federator's (each over an empty own registry), marks
  ``rdp_replica_up`` 1 for a live member and 0 once it stops answering,
  and still serves the dead member's last good scrape; its roll-ups set
  the same fleet gauges; its span and journal payloads follow the same
  live-then-last-good discipline;
- the ``/debug/trace`` stitcher (the front-end's ``trace_debug``) builds
  the same distributed tree from the same recorder and replica payloads.

Tolerances, fixed before measuring: none. Texts, payloads and trees are
compared exactly (ages, which are wall-clock, are checked apart).
"""

import json

import pytest

from robotic_discovery_platform_tpu.observability import (
    federation as jfed,
)
from robotic_discovery_platform_tpu.observability import (
    instruments as jobs,
)
from robotic_discovery_platform_tpu.observability import (
    recorder as jrecorder,
)
from robotic_discovery_platform_tpu.observability import (
    registry as jregistry,
)
from robotic_discovery_platform_tpu.serving import fleet as jfleet
from robotic_discovery_platform_tpu.serving import frontend as jfrontend
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.observability import (
    federation as tfed,
)
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as tobs,
)
from robotic_discovery_platform_tpu_torch.observability import (
    recorder as trecorder,
)
from robotic_discovery_platform_tpu_torch.observability import (
    registry as tregistry,
)
from robotic_discovery_platform_tpu_torch.serving import fleet as tfleet
from robotic_discovery_platform_tpu_torch.serving import frontend as tfrontend
from robotic_discovery_platform_tpu_torch.utils import config

PKGS = {
    "port": (tfed, tobs, tregistry, tfleet, tfrontend, config, trecorder),
    "jax": (jfed, jobs, jregistry, jfleet, jfrontend, jconfig, jrecorder),
}

EXPOSITIONS = [
    "# HELP rdp_frames_total Frames.\n# TYPE rdp_frames_total counter\n"
    'rdp_frames_total{status="ok",model="seg"} 12\n'
    'rdp_frames_total{status="error",model="seg"} 1\n',
    "# HELP rdp_stage_seconds Stage latency.\n"
    "# TYPE rdp_stage_seconds histogram\n"
    'rdp_stage_seconds_bucket{stage="total",le="0.01"} 3\n'
    'rdp_stage_seconds_bucket{stage="total",le="+Inf"} 4\n'
    'rdp_stage_seconds_sum{stage="total"} 0.05\n'
    'rdp_stage_seconds_count{stage="total"} 4\n',
    "rdp_orphan_total 7\nrdp_orphan_seconds_sum 1.5\n"
    "# comment line\n\n"
    '# HELP rdp_weird A "quoted" \\ help.\n# TYPE rdp_weird gauge\n'
    'rdp_weird{path="a\\"b\\\\c"} 1\nrdp_weird 2\n',
    "",
]


@pytest.mark.parametrize("label_value", [None, "localhost:5001",
                                         'we"ird\\host\nx'])
def test_relabel_and_merge_are_byte_equal_to_jax(label_value):
    merged = {}
    for pkg, mods in PKGS.items():
        fed = mods[0]
        families = fed.relabel(EXPOSITIONS[0], "replica", None)
        for i, text in enumerate(EXPOSITIONS):
            value = None if label_value is None else f"{label_value}{i}"
            fed.relabel(text, "replica", value, families)
        merged[pkg] = fed.merge_exposition(families)
    assert merged["port"] == merged["jax"]
    assert merged["port"].count("# HELP rdp_frames_total") == 1


class _Fetch:
    """A fake HTTP GET per package: each URL's canned body, or an error
    for a member marked down."""

    def __init__(self):
        self.down = set()
        self.bodies = {}

    def __call__(self, url, timeout):
        for base in self.down:
            if url.startswith(base):
                raise OSError(f"{base} is down")
        return self.bodies[url]


def _targets(fed):
    stats = {"burn": 0.5, "frames_total": 10, "draining": False,
             "models": {"seg": {"frames": 10, "rate": 2.5}}}
    return [fed.ScrapeTarget("r1:1", "http://r1:9100", dict(stats)),
            fed.ScrapeTarget("r2:1", "http://r2:9100",
                             dict(stats, burn=1.5, draining=True)),
            fed.ScrapeTarget("r3:1", None, {})]


def test_federator_render_and_last_good_match_jax():
    out = {}
    for pkg, (fed, obs, reg, *_rest) in PKGS.items():
        fetch = _Fetch()
        for i, base in enumerate(("http://r1:9100", "http://r2:9100")):
            fetch.bodies[f"{base}/metrics"] = EXPOSITIONS[i]
            fetch.bodies[f"{base}/debug/spans"] = json.dumps(
                {"role": "replica", "host": f"h{i}", "recent": [],
                 "pinned": []})
            fetch.bodies[f"{base}/debug/events"] = json.dumps(
                {"host": f"h{i}", "role": "replica", "events": [],
                 "dropped_total": 0})
        targets = _targets(fed)
        federator = fed.FleetFederator(lambda: targets,
                                       registry=reg.MetricsRegistry(),
                                       fetch=fetch)
        first = federator.render()
        up1 = [obs.REPLICA_UP.labels(replica=r).value
               for r in ("r1:1", "r2:1", "r3:1")]
        fetch.down.add("http://r2:9100")
        second = federator.render()
        up2 = [obs.REPLICA_UP.labels(replica=r).value
               for r in ("r1:1", "r2:1", "r3:1")]
        ages = [obs.REPLICA_SCRAPE_AGE.labels(replica=r).value
                for r in ("r1:1", "r2:1", "r3:1")]
        draining = [obs.REPLICA_DRAINING.labels(replica=r).value
                    for r in ("r1:1", "r2:1")]
        spans = [(t.replica, p, fresh)
                 for t, p, _age, fresh in federator.span_payloads()]
        journals = [(t.replica, p, fresh)
                    for t, p, _age, fresh in federator.journal_payloads()]
        rollups = [obs.FLEET_BURN.labels(stat="mean").value,
                   obs.FLEET_BURN.labels(stat="max").value,
                   obs.FLEET_FRAMES.value,
                   obs.FLEET_MODEL_ARRIVAL_RATE.labels(model="seg").value]
        out[pkg] = (first, second, up1, up2, draining, spans, journals,
                    rollups, federator.renders)
        assert ages[0] >= 0.0 and ages[1] >= 0.0 and ages[2] == -1.0
    assert out["port"] == out["jax"]
    first, second, up1, up2 = out["port"][:4]
    assert up1 == [1.0, 1.0, 0.0] and up2 == [1.0, 0.0, 0.0]
    # the dead member's last good scrape is still served, under its label
    assert 'replica="r2:1"' in second and second == first
    # burns 0.5, 1.5 and the statless member's 0; frames and rates summed
    assert out["port"][7] == [pytest.approx(2.0 / 3.0), 1.5, 20.0, 5.0]


def _recorder_with_relay(recorder_lib, trace_id):
    recorder = recorder_lib.FlightRecorder(capacity=8)
    tl = recorder_lib.Timeline("relay")
    root = tl.span("relay", start_ns=0, trace_id=trace_id)
    tl.span("send", start_ns=10, end_ns=20, parent=root, trace_id=trace_id,
            replica="r1:1", attempt=1)
    root.end(30)
    recorder.record(tl)
    return recorder


class _SpanFederator:
    def __init__(self, fed, payloads):
        self.fed = fed
        self.payloads = payloads

    def span_payloads(self):
        return [(self.fed.ScrapeTarget(ep, None, {}), p, 1.5, fresh)
                for ep, p, fresh in self.payloads]

    def stop(self):
        pass


def test_trace_stitching_matches_jax():
    """One frame's front-end relay timeline and a replica's dispatch
    timeline (a live member and a dead one's last good payload) stitch
    into the same tree in both packages; a bad id is refused alike."""
    tid = "0123456789abcdef0123456789abcdef"
    replica_payload = {
        "role": "replica", "host": "hr",
        "recent": [{"seq": 3, "name": "dispatch", "labels": {"b": "1"},
                    "error": None, "created_unix_s": 5.0,
                    "duration_ms": 2.0,
                    "spans": [{"span_id": "a", "parent_id": None,
                               "trace_id": tid, "name": "dispatch"},
                              {"span_id": "b", "parent_id": "a",
                               "trace_id": tid, "name": "forward"},
                              {"span_id": "c", "parent_id": "zz",
                               "trace_id": tid, "name": "orphan"}]},
                   {"seq": 4, "name": "other", "spans": [
                       {"span_id": "d", "trace_id": "f" * 32}]}],
        "pinned": [{"seq": 3, "spans": [{"trace_id": tid}]}]}
    out = {}
    for pkg, (fed, _obs, _reg, fleet_lib, fe_lib, cfg_mod, rec) in (
            PKGS.items()):
        router = fleet_lib.FleetRouter(["r1:1"],
                                       channel_factory=lambda ep: None)
        fe = fe_lib.FleetFrontend(router, cfg_mod.ServerConfig(
            fleet_replicas="r1:1"),
            flight_recorder=_recorder_with_relay(rec, tid))
        try:
            fe.federator = _SpanFederator(fed, [
                ("r1:1", replica_payload, True),
                ("r2:1", replica_payload, False),
                ("r3:1", None, False)])
            got = fe.trace_debug(tid.upper())
            bad = fe.trace_debug("nope")
        finally:
            fe.close()
        for source in got["sources"]:
            source.pop("host")
            for tl in source["timelines"]:
                tl.pop("created_unix_s", None)
                tl.pop("duration_ms", None)
                for span in tl.get("spans", []):
                    for key in ("start_ns", "end_ns", "span_id",
                                "parent_id", "thread", "duration_ms"):
                        span.pop(key, None)
        for child in got["tree"]["children"]:
            child.pop("host")
        got["tree"] = json.loads(json.dumps(got["tree"], default=str))
        out[pkg] = (got["timelines_total"], got["sources"][1:],
                    [c["role"] for c in got["tree"]["children"]], bad)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 3  # one relay, the live and the stale member
    assert out["port"][2] == ["frontend", "replica", "replica"]
    assert out["port"][3]["error"].startswith("bad trace id")


def test_stitch_helpers_match_jax():
    tid = "ab" * 16
    snapshot = {"recent": [
        {"seq": 2, "created_unix_s": 2.0, "spans": [
            {"span_id": "x", "parent_id": None, "trace_id": tid},
            {"span_id": "y", "parent_id": "x", "trace_id": tid},
            {"span_id": "z", "parent_id": "z", "trace_id": tid}]},
        {"seq": 1, "created_unix_s": 1.0, "spans": [{"trace_id": tid}]}],
        "pinned": [{"seq": 2, "spans": [{"trace_id": tid}]},
                   {"seq": 7, "spans": [{"trace_id": "0" * 32}]}]}
    for fn in ("_matching_timelines",):
        assert (getattr(tfrontend, fn)(snapshot, tid)
                == getattr(jfrontend, fn)(snapshot, tid))
    spans = snapshot["recent"][0]["spans"]
    assert tfrontend._span_forest(spans) == jfrontend._span_forest(spans)
    sources = [{"role": "frontend", "host": "h", "endpoint": None,
                "fresh": True,
                "timelines": tfrontend._matching_timelines(snapshot, tid)},
               {"role": "replica", "host": "h2", "endpoint": "r:1",
                "fresh": False, "timelines": []}]
    assert (tfrontend._stitch_tree(tid, sources)
            == jfrontend._stitch_tree(tid, sources))
