"""The drift loop's serving half on the CPU: the port's
``monitoring/profile.py`` and ``monitoring/drift.py`` and the servicer's
drift monitor against the JAX package's.

Tolerances, fixed before measuring:

- ``psi``, ``psi_noise_floor``, ``js_distance``, ``score_sketches`` and
  the monitor's scores and recommendations on equal inputs: equal (the
  same float64 Python arithmetic in both packages);
- a profile's JSON: ``to_dict`` equal both ways;
- ``frame_signals`` of the same weights and frames: validity and the
  depth-valid fraction equal, coverage equal (the port's coverage is the
  JAX product to the bit at 120x160, tests/test_torch_port_pipeline.py),
  curvatures rtol 1e-3 and the confidence margin rtol 1e-5
  (tests/test_torch_port_serving.py's bars), the profiles' sketch counts
  equal;
- the servicer's ``rdp_drift_*`` and ``rdp_model_confidence_margin``
  samples over the same frames: drift scores, recommendation count and
  the margin histogram's bucket counts equal, its sum rtol 1e-5;
  ``drift_debug()`` equal but for its clock readings, floats within the
  signals' bars;
- ``analyze_drift`` over a CSV of the port's ``MetricsWriter``: the JAX
  report (its means rtol 1e-12: pandas and numpy sum alike but need not
  in the last bit).
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet
from robotic_discovery_platform_tpu.monitoring import drift as jdrift
from robotic_discovery_platform_tpu.monitoring import profile as jprofile
from robotic_discovery_platform_tpu.observability import (
    instruments as jobs,
)
from robotic_discovery_platform_tpu.observability.sketch import (
    StreamingSketch as JaxSketch,
)
from robotic_discovery_platform_tpu.ops import bspline as jbspline
from robotic_discovery_platform_tpu.ops import geometry as jgeom
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.monitoring import drift, profile
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as obs,
)
from robotic_discovery_platform_tpu_torch.observability.sketch import (
    StreamingSketch,
)
from robotic_discovery_platform_tpu_torch.ops import pipeline
from robotic_discovery_platform_tpu_torch.ops.unet_infer import FoldedUNet
from robotic_discovery_platform_tpu_torch.serving import ingest
from robotic_discovery_platform_tpu_torch.serving import server as tserver
from robotic_discovery_platform_tpu_torch.serving.metrics import (
    MetricsWriter,
)
from robotic_discovery_platform_tpu_torch.training import trainer
from robotic_discovery_platform_tpu_torch.utils import config

NAME = "Actuator-Segmenter"
H, W, SIZE = 120, 160, 64
JCFG = jconfig.ModelConfig(base_features=8, compute_dtype="float32")
CFG = config.ModelConfig(base_features=8, compute_dtype="float32")


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


@pytest.fixture(scope="module", autouse=True)
def _jax_registry_loads_without_a_template():
    """The JAX package's registry load restores the msgpack into a
    template from an eager ``init_unet`` at 256x256, about 25 s the first
    time in a process; the JAX servicers here restore the same bytes
    without one (the same values, as nested dicts)."""
    from flax import serialization

    from robotic_discovery_platform_tpu.tracking import api as japi

    def load_model_dir(path):
        path = Path(path)
        cfg = jconfig.from_dict(jconfig.ModelConfig, json.loads(
            (path / japi._MODEL_CONFIG_FILE).read_text()))
        return build_unet(cfg), serialization.msgpack_restore(
            (path / japi._MODEL_WEIGHTS_FILE).read_bytes())

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(japi, "load_model_dir", load_model_dir)
        yield


# -- scoring -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    lo, hi, bins = 0.0, 1.0 + seed, 8 + 8 * seed
    a = rng.normal(0.5, 0.2, 64 * (seed + 1))
    b = rng.normal(0.6 + 0.1 * seed, 0.3, 48)
    ref, live = (StreamingSketch.from_values(lo, hi, bins, v) for v in (a, b))
    jref, jlive = (JaxSketch.from_values(lo, hi, bins, v) for v in (a, b))
    assert profile.psi(ref.counts(), live.counts()) == jprofile.psi(
        jref.counts(), jlive.counts())
    assert profile.psi_noise_floor(ref.counts(), live.counts()) == (
        jprofile.psi_noise_floor(jref.counts(), jlive.counts()))
    assert profile.js_distance(ref.probabilities(), live.probabilities()) == (
        jprofile.js_distance(jref.probabilities(), jlive.probabilities()))
    assert tuple(profile.score_sketches(ref, live)) == tuple(
        jprofile.score_sketches(jref, jlive))
    spec = profile.SERVING_SIGNALS["confidence_margin"]
    assert tuple(profile.score_value_lists(spec, a, b)) == tuple(
        jprofile.score_value_lists(spec, a, b))
    assert profile.SERVING_SIGNALS == {
        k: tuple(v) for k, v in jprofile.SERVING_SIGNALS.items()}


def _filled(module, seed: int, generation):
    rng = np.random.default_rng(seed)
    prof = module.FeatureProfile(generation=generation, source="capture",
                                 created_unix=1.7e9)
    for _ in range(40):
        prof.observe({"mask_coverage": rng.uniform(0, 100),
                      "mean_curvature": rng.uniform(0, 30),
                      "max_curvature": (math.nan if rng.random() < 0.2
                                        else rng.uniform(0, 60)),
                      "depth_valid_fraction": rng.uniform(0.5, 1.0),
                      "confidence_margin": rng.uniform(0, 0.5)})
    return prof


def test_profile_round_trips_between_the_packages(tmp_path):
    port = _filled(profile, 3, generation=2)
    ref = _filled(jprofile, 3, generation=2)
    assert port.to_dict() == ref.to_dict()
    port.save(tmp_path / "port.json")
    ref.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
    assert jprofile.FeatureProfile.load(
        tmp_path / "port.json").to_dict() == port.to_dict()
    assert profile.FeatureProfile.load(
        tmp_path / "jax.json").to_dict() == ref.to_dict()


def test_profile_path_resolves_as_in_the_jax_package(monkeypatch):
    monkeypatch.delenv("RDP_DRIFT_PROFILE", raising=False)
    for configured in ("", "  ", "a.json"):
        assert profile.resolve_drift_profile_path(configured) == (
            jprofile.resolve_drift_profile_path(configured))
    monkeypatch.setenv("RDP_DRIFT_PROFILE", "/env/wins.json")
    assert profile.resolve_drift_profile_path("a.json") == "/env/wins.json"


# -- the monitor ---------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _signal_stream(seed: int, n: int):
    """Five signals per frame: in distribution, then the depth fraction
    and coverage shifted, back, shifted again after the cooldown, with a
    NaN curvature now and then."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        shifted = 96 <= i < 200 or i >= 330
        yield {
            "mask_coverage": rng.uniform(10, 30) + (40 if shifted else 0),
            "mean_curvature": (math.nan if i % 7 == 0
                               else rng.uniform(1, 5)),
            "max_curvature": rng.uniform(2, 20),
            "depth_valid_fraction": rng.uniform(0.4, 0.5 if shifted
                                                else 1.0),
            "confidence_margin": rng.uniform(0.2, 0.4),
        }


def _run_monitor(module, reference):
    clock = _Clock()
    scored, fired = [], []
    mon = module.DriftMonitor(
        reference=reference, window=64, baseline_frames=32, score_every=8,
        psi_threshold=0.25, sustain_s=1.0, cooldown_s=6.0, generation=4,
        on_score=lambda name, s: scored.append((mon.frames_observed, name,
                                                tuple(s))),
        clock=clock)
    for i, signals in enumerate(_signal_stream(9, 420)):
        clock.t += 0.05
        rec = mon.observe_frame(signals)
        if rec is not None:
            d = rec.to_dict()
            d.pop("fired_unix")
            d.pop("reason")
            fired.append((i, d, clock.t))
    snap = mon.snapshot()
    return scored, fired, snap, mon.recommendations_total


@pytest.mark.parametrize("reference", ["self-baseline", "profile"])
def test_monitor_matches_the_jax_monitor(reference):
    """The same observations under the same fake clock: the same scores at
    the same frames, a recommendation at the same frame of each
    excursion, and the same cooldown (the second excursion fires only
    once the cooldown has passed)."""
    got = _run_monitor(profile, None if reference == "self-baseline"
                       else _filled(profile, 5, generation=4))
    want = _run_monitor(jprofile, None if reference == "self-baseline"
                        else _filled(jprofile, 5, generation=4))
    assert got[0] == want[0] and got[0]
    assert got[1] == want[1]
    assert got[3] == want[3] == len(got[1]) >= 1
    for snap in (got[2], want[2]):
        for part in ("reference",):
            if snap[part] is not None:
                snap[part].pop("created_unix")
                snap[part].pop("age_s")
        snap["recommendations"]["last"].pop("fired_unix")
    assert got[2] == want[2]


def test_unequal_samples_score_above_the_floor_as_in_the_jax_package():
    """One signal held in one cell of a 16-frame reference and of the
    default 256-frame live window: the PSI's pseudo-count weighs the two
    samples' empty cells unequally, so once the window passes about 56
    frames the score tops 0.25 plus its noise floor and the monitor fires
    on an unchanged distribution -- in both packages, at the same frame
    with the same score (ROADMAP queue 3)."""
    def run(module):
        ref = module.FeatureProfile({"x": module.SignalSpec(0.0, 1.0)},
                                    generation=1, created_unix=0.0)
        for _ in range(16):
            ref.observe({"x": 1.0})
        clock = _Clock()
        mon = module.DriftMonitor(reference=ref, sustain_s=0.0, clock=clock)
        for i in range(256):
            clock.t += 0.01
            if mon.observe_frame({"x": 1.0}) is not None:
                return i, tuple(mon.scores["x"])
        return None

    got = run(profile)
    assert got is not None and got == run(jprofile)
    assert got[0] == 63 and got[1][0] > 0.25 + got[1][4]


# -- frame signals and capture -------------------------------------------------


def _variables(seed: int) -> dict:
    """A base-8 net from the port's seeded init as numpy Flax variables,
    BatchNorm statistics from a numpy seed and the head bias at a frame's
    median logit, so masks are structured (tests/test_torch_port_deploy.
    py's recipe, without the JAX init's compile)."""
    net = trainer.init_model(CFG, seed, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith(".var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.05, 0.2, tuple(buf.shape)).astype(np.float32)))
            elif name.endswith(".mean"):
                buf.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.1, tuple(buf.shape)).astype(np.float32)))
    variables = weights.to_flax_variables(net.eval())
    rgb, _, _ = render_scene(np.random.default_rng(100), H, W)
    x = torch.from_numpy(np.array(
        jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)))
    with torch.no_grad():
        median = float(torch.median(FoldedUNet(net, device="cpu")(x)))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return variables


@jax.jit
def _chord_max(mask, depth):
    k = ingest.default_intrinsics(W, H).astype(np.float32)
    maps = jgeom.deproject(mask, depth, k[0, 0], k[1, 1], k[0, 2], k[1, 2],
                           jnp.float32(0.001))
    e = jgeom._edge_points(*maps, jconfig.GeometryConfig(kernel_impl="xla"))
    pts, wts = jgeom._sort_by_x(e[0], e[1])
    return jnp.max(jbspline.chord_length_params(pts, wts))


def _keeps_every_edge_point(mask, depth) -> bool:
    """False on frames where the JAX package drops its last edge point
    from the spline fit, where the port's curvature differs by design
    (tests/test_torch_port_pipeline.py::test_chord_parameters_clip_at_one)."""
    return float(_chord_max(jnp.asarray(mask), jnp.asarray(depth))) <= 1.0


@pytest.fixture(scope="module")
def model():
    variables = _variables(0)
    net = weights.unet_from_flax_variables(CFG, variables)
    return build_unet(JCFG), variables, net


@pytest.fixture(scope="module")
def scenes(model):
    """Twelve 120x160 scenes whose reference spline keeps every edge point
    (so the two packages' curvatures compare), half with the lower half of
    the depth frame zeroed, and the two packages' analyses of each."""
    jmodel, variables, net = model
    janalyze = jpipe.make_frame_analyzer(jmodel, img_size=SIZE)
    analyze = pipeline.make_frame_analyzer(FoldedUNet(net, device="cpu"),
                                           img_size=SIZE, device="cpu")
    k = ingest.default_intrinsics(W, H).astype(np.float32)
    rng = np.random.default_rng(200)
    out = []
    while len(out) < 12:
        rgb, _, depth = render_scene(rng, H, W)
        if len(out) % 2:
            depth = depth.copy()
            depth[H // 2:] = 0
        ja = janalyze(variables, rgb, depth, k, np.float32(0.001))
        if bool(ja.profile.valid) and not _keeps_every_edge_point(
                np.asarray(ja.mask), depth):
            continue
        out.append((rgb, depth, ja, analyze(rgb, depth, k, 0.001)))
    return out


def _close_signals(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in ("mask_coverage", "depth_valid_fraction"):
        assert got[key] == want[key], key
    for key in ("mean_curvature", "max_curvature"):
        assert math.isnan(got[key]) == math.isnan(want[key]), key
        if not math.isnan(want[key]):
            assert got[key] == pytest.approx(want[key], rel=1e-3), key
    assert got["confidence_margin"] == pytest.approx(
        want["confidence_margin"], rel=1e-5)


def test_frame_signals_match_the_jax_package(scenes):
    fractions = set()
    for _, depth, ja, ta in scenes:
        got = profile.frame_signals(ta, depth)
        _close_signals(got, jprofile.frame_signals(ja, depth))
        fractions.add(got["depth_valid_fraction"] < 0.6)
    assert fractions == {True, False}


def test_capture_matches_the_jax_capture(model, scenes):
    jmodel, variables, net = model
    frames = [(rgb, depth) for rgb, depth, _, _ in scenes]
    got = profile.capture_feature_profile(net, frames, img_size=SIZE,
                                          generation=7, device="cpu")
    want = jprofile.capture_feature_profile(jmodel, variables, frames,
                                            img_size=SIZE, generation=7)
    assert (got.generation, got.source, got.n_frames) == (
        want.generation, want.source, want.n_frames) == (7, "capture", 12)
    for name, sketch in got.sketches.items():
        assert sketch.counts() == want.sketches[name].counts(), name
        assert sketch.non_finite == want.sketches[name].non_finite, name


# -- the servicer --------------------------------------------------------------


def _register(uri: str, variables: dict) -> int:
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(uri)
    try:
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(variables, JCFG,
                                          registered_model_name=NAME)
        jtracking.Client().set_registered_model_alias(NAME, "staging",
                                                      version)
    finally:
        jtracking.set_tracking_uri(prev)
    return version


#: the drift settings of the servicer tests: a short baseline and window,
#: no sustain (the first scoring pass above threshold fires), one
#: recommendation per run
DRIFT = dict(drift_baseline_frames=16, drift_window=32, drift_score_every=8,
             drift_sustain_s=0.0)


def _servicers(uri, tmp_path, **fields):
    common = dict(address="localhost:0", tracking_uri=uri,
                  model_img_size=SIZE,
                  calibration_path=str(tmp_path / "none.npz"),
                  reload_poll_s=0.0, **fields)
    service = tserver.build_service(config.ServerConfig(
        metrics_csv=str(tmp_path / "p.csv"), **common), device="cpu")
    jcfg = jconfig.ServerConfig(metrics_csv=str(tmp_path / "j.csv"), **common)
    prev = jtracking.get_tracking_uri()
    try:
        jmodel, jvars, version = jserver.resolve_serving_model(jcfg)
    finally:
        jtracking.set_tracking_uri(prev)
    jservice = jserver.VisionAnalysisService(jmodel, jvars, None, 0.001, jcfg,
                                             version=version)
    return service, jservice


def _samples(module) -> dict:
    """The drift families' samples: {(name, labels): value}, the scores
    of the default model only (the JAX package's zoo tests set others)."""
    out = {}
    for family in (module.DRIFT_SCORE, module.DRIFT_RECOMMENDATIONS,
                   module.MODEL_CONFIDENCE_MARGIN):
        for s in family.samples():
            labels = dict(s.labels)
            if labels.get("model", tserver.MODEL_LABEL) == tserver.MODEL_LABEL:
                out[(family.name + s.suffix,
                     tuple(sorted(labels.items())))] = s.value
    return out


def _serve(service, jservice, frames) -> None:
    """The port serves ``frames`` as one stream (its real path); the JAX
    servicer analyzes each and feeds its monitor as its stream does."""
    answers = list(service.analyze_stream(iter(
        [ingest.raw_request(rgb, depth, mask_format=1)
         for rgb, depth in frames])))
    assert not [a.status for a in answers if a.status.startswith("ERROR")]
    for rgb, depth in frames:
        jservice._observe_drift(jservice._analyze_frame(rgb, depth,
                                                        mask_format=1))


def _close_trees(got, want, path=""):
    """Equal structure, ints/strings/bools equal, floats within the
    signals' widest bar (rtol 1e-3)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_trees(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=1e-3, nan_ok=True), path
    else:
        assert got == want, path


def _debug(service) -> dict:
    snap = json.loads(json.dumps(service.drift_debug()))
    if snap.get("reference"):
        for key in ("created_unix", "age_s"):
            snap["reference"].pop(key)
    last = snap["recommendations"]["last"]
    if last is not None:
        last.pop("fired_unix")
        last.pop("reason")  # carries the scores at 3 decimals
    return snap


def test_servicer_monitors_as_the_jax_servicer(model, scenes, tmp_path):
    """Both servicers start from the registry with no profile (a
    self-baseline), serve the same frames -- the in-distribution ones,
    then those with the lower half of the depth frame zeroed -- and end
    with the same drift metrics, one recommendation naming
    depth_valid_fraction, and the same ``drift_debug()``."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, model[1])
    assert config.ServerConfig().drift_enabled
    service, jservice = _servicers(uri, tmp_path, **DRIFT)
    inside = [(rgb, d) for rgb, d, _, _ in scenes[0::2]]
    shifted = [(rgb, d) for rgb, d, _, _ in scenes[1::2]]
    before, jbefore = _samples(obs), _samples(jobs)
    try:
        assert service.drift is not None and service.drift.reference is None
        assert _debug(service)["state"] == "baselining"
        _serve(service, jservice, inside * 4)
        assert service.drift.reference.source == "self-baseline"
        assert service.drift.recommendations_total == 0
        _serve(service, jservice, shifted * 4)
        got = {k: v - before.get(k, 0.0) if "drift_score" not in k[0]
               else v for k, v in _samples(obs).items()}
        want = {k: v - jbefore.get(k, 0.0) if "drift_score" not in k[0]
                else v for k, v in _samples(jobs).items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            if key[0].endswith("_sum"):
                assert got[key] == pytest.approx(value, rel=1e-5), key
            else:
                assert got[key] == value, key
        n = len(inside) * 4 + len(shifted) * 4
        assert got[("rdp_model_confidence_margin_count", ())] == n
        assert got[("rdp_drift_recommendations_total", ())] == 1
        rec = service.drift.recommendations[-1]
        assert "depth_valid_fraction" in rec.signals
        assert rec.signals == jservice.drift.recommendations[-1].signals
        _close_trees(_debug(service), _debug(jservice))
        assert service.version_and_reference() == (
            jservice.version_and_reference()) == (1, 1)
    finally:
        service.close()
        jservice.close()


def test_servicer_reference_sources(model, tmp_path, caplog):
    """A registry artifact is the reference; an unusable explicit profile
    is logged and falls back to it; with neither, a self-baseline;
    drift_enabled=False builds no monitor. As in the JAX servicer."""
    uri = f"file:{tmp_path}/mlruns"
    version = _register(uri, model[1])
    artifact = (jtracking.store_for(uri).version_path(NAME, version)
                / profile.DRIFT_PROFILE_FILE)
    _filled(profile, 4, generation=version).save(artifact)
    (tmp_path / "bad.json").write_text("{not json")
    for fields, source in (({}, "capture"),
                           ({"drift_profile_path": str(tmp_path / "bad.json")},
                            "capture"),
                           ({"drift_enabled": False}, None)):
        service, jservice = _servicers(uri, tmp_path, **fields)
        try:
            for s in (service, jservice):
                if source is None:
                    assert s.drift is None
                    assert s.drift_debug()["enabled"] is False
                else:
                    assert s.drift.reference.source == source
                    assert s.drift.reference.generation == version
            if "drift_profile_path" in fields:
                assert "drift profile" in caplog.text
                assert "unusable" in caplog.text
        finally:
            service.close()
            jservice.close()
    artifact.unlink()
    service, jservice = _servicers(uri, tmp_path)
    try:
        assert service.drift.reference is None
        assert jservice.drift.reference is None
        assert service.drift_debug()["generation"] == (
            jservice.drift_debug()["generation"]) == version
    finally:
        service.close()
        jservice.close()


def test_hot_reload_adopts_the_new_reference(model, scenes, tmp_path):
    """Version 2 ships a profile, version 3 none: after each reload the
    monitor's reference is the new version's (its profile, then a
    self-baseline stamped 3), paired with the engine, in both packages."""
    uri = f"file:{tmp_path}/mlruns"
    _register(uri, model[1])
    service, jservice = _servicers(uri, tmp_path, **DRIFT)
    frames = [(rgb, d) for rgb, d, _, _ in scenes[0::2]]
    try:
        _serve(service, jservice, frames * 3)
        v2 = _register(uri, _variables(1))
        _filled(profile, 6, generation=v2).save(
            jtracking.store_for(uri).version_path(NAME, v2)
            / profile.DRIFT_PROFILE_FILE)
        for s in (service, jservice):
            assert s.maybe_reload()
            assert s.version_and_reference() == (v2, v2)
            assert s.drift.reference.source == "capture"
            assert s.drift.frames_observed == 0
        debug = service.drift_debug()
        assert debug["model_version"] == debug["generation"] == v2
        v3 = _register(uri, _variables(2))
        for s in (service, jservice):
            assert s.maybe_reload()
            assert s.version_and_reference() == (v3, v3)
            assert s.drift.reference is None
        _serve(service, jservice, frames * 3)
        _close_trees(_debug(service), _debug(jservice))
    finally:
        service.close()
        jservice.close()


# -- the offline detector ------------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, 12.0])
def test_analyze_drift_over_the_port_metrics_csv(shift, tmp_path):
    """Rows written by the port's MetricsWriter (then a malformed and a
    truncated one): the JAX report, field by field."""
    path = tmp_path / "m.csv"
    writer = MetricsWriter(path, flush_every=8)
    rng = np.random.default_rng(11)
    for i in range(120):
        writer.append(float(rng.uniform(1, 4)), float(rng.uniform(4, 9)),
                      float(rng.normal(40 + (shift if i >= 60 else 0), 2)))
    writer.close()
    with open(path, "a") as f:
        f.write("2026-01-01 00:00:00.0,0.1,0.2,not-a-number\n"
                "2026-01-01 00:00:01.0,0.3")
    cfg = config.DriftConfig(metrics_csv=str(path),
                             report_path=str(tmp_path / "r.png"))
    jcfg = jconfig.DriftConfig(**dataclasses.asdict(cfg))
    got = drift.analyze_drift(cfg, render=True)
    want = jdrift.analyze_drift(jcfg, render=False)
    assert got.drifted == (shift > 0)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "report_path":
            assert (tmp_path / "r.png").read_bytes().startswith(b"\x89PNG")
        elif f.name in ("baseline_mean", "recent_mean", "relative_change"):
            assert g == pytest.approx(w, rel=1e-12), f.name
        else:
            assert g == w, f.name
    missing = drift.analyze_drift(config.DriftConfig(
        metrics_csv=str(tmp_path / "none.csv")))
    assert dataclasses.asdict(missing) == dataclasses.asdict(
        jdrift.analyze_drift(jconfig.DriftConfig(
            metrics_csv=str(tmp_path / "none.csv"))))
