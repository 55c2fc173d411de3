"""The drift loop's training half on the CPU: the port's
``workflows/retraining.py`` (train, register, promote ``staging``, ship
the version's drift profile) and its profile capture against the JAX
package's.

Tolerances, fixed before measuring: the pipeline's results, the registry's
alias and the profile's provenance exact; the capture guard's
per-instance counts equal to the JAX package's trace counts; a profile
the port writes loads in the JAX package with ``to_dict`` equal.
"""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.analysis import recompile as jrecompile
from robotic_discovery_platform_tpu.models.unet import build_unet
from robotic_discovery_platform_tpu.monitoring import profile as jprofile
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu.workflows import retraining as jretraining
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.analysis import recompile
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.monitoring import profile
from robotic_discovery_platform_tpu_torch.serving.metrics import (
    MetricsWriter,
)
from robotic_discovery_platform_tpu_torch.training import synthetic, trainer
from robotic_discovery_platform_tpu_torch.utils import config
from robotic_discovery_platform_tpu_torch.workflows import retraining

NAME = "Actuator-Segmenter"
TINY = config.ModelConfig(base_features=8, compute_dtype="float32")


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


@pytest.fixture(scope="module")
def arrays():
    return synthetic.generate_arrays(8, 32, 32, seed=0)


def _cfg(tmp_path, **fields) -> config.TrainConfig:
    return config.TrainConfig(
        epochs=1, batch_size=4, img_size=32, learning_rate=1e-3,
        validation_split=0.25, tracking_uri=f"file:{tmp_path}/mlruns",
        checkpoint_dir=str(tmp_path / "ckpt"), **fields)


def test_pipeline_promotes_staging_and_ships_the_profile(tmp_path, arrays):
    """Two cycles: each registers the next version, moves ``staging`` to
    it and writes its ``drift_profile.json`` (16 frames at 120x160, the
    version as its generation) next to its weights; the JAX package loads
    the profile unchanged."""
    cfg = _cfg(tmp_path)
    store = tracking.store_for(cfg.tracking_uri)
    for version in (1, 2):
        res = retraining.run_retraining_pipeline(cfg, TINY, arrays=arrays,
                                                 device="cpu")
        assert (res.succeeded, res.version, res.promoted_alias) == (
            True, version, "staging"), res.message
        assert store.get_alias(NAME, "staging") == version
        path = Path(res.drift_profile_path)
        assert path == (store.version_path(NAME, version)
                        / profile.DRIFT_PROFILE_FILE)
        prof = profile.FeatureProfile.load(path)
        assert (prof.generation, prof.source, prof.n_frames) == (
            version, "capture", 16)
        assert prof.spec == profile.SERVING_SIGNALS
        assert prof.sketches["depth_valid_fraction"].count == 16
        assert jprofile.FeatureProfile.load(path).to_dict() == prof.to_dict()


@pytest.mark.parametrize("when", ["before_training", "before_promotion"])
def test_cancel_returns_without_promoting(when, tmp_path, arrays,
                                          monkeypatch):
    cfg = _cfg(tmp_path)
    cancel = threading.Event()
    if when == "before_training":
        cancel.set()
        got = retraining.run_retraining_pipeline(cfg, TINY, arrays=arrays,
                                                 cancel=cancel, device="cpu")
        want = jretraining.run_retraining_pipeline(
            jconfig.TrainConfig(**dataclasses.asdict(cfg)), cancel=cancel)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.message == "cancelled before training started"
        assert not (tmp_path / "mlruns").exists()
        return
    train = trainer.train_model

    def train_then_cancel(*args, **kwargs):
        result = train(*args, **kwargs)
        cancel.set()
        return result

    monkeypatch.setattr(trainer, "train_model", train_then_cancel)
    got = retraining.run_retraining_pipeline(cfg, TINY, arrays=arrays,
                                             cancel=cancel, device="cpu")
    assert (got.succeeded, got.version, got.promoted_alias) == (
        False, 1, None)
    assert "registered but NOT promoted" in got.message
    store = tracking.store_for(cfg.tracking_uri)
    assert store.get_alias(NAME, "staging") is None
    assert not (store.version_path(NAME, 1)
                / profile.DRIFT_PROFILE_FILE).exists()


def _csv(path: Path, shift: float) -> None:
    writer = MetricsWriter(path, flush_every=16)
    rng = np.random.default_rng(3)
    for i in range(100):
        writer.append(2.0, 5.0, float(rng.normal(
            30.0 + (shift if i >= 50 else 0.0), 1.0)))
    writer.close()


def test_run_if_drifted(tmp_path, arrays):
    """None when the metrics CSV has not drifted (as the JAX package);
    a full cycle when it has."""
    cfg = _cfg(tmp_path)
    _csv(tmp_path / "stable.csv", 0.0)
    stable = config.DriftConfig(metrics_csv=str(tmp_path / "stable.csv"))
    assert retraining.run_if_drifted(stable, cfg, TINY, arrays=arrays,
                                     device="cpu") is None
    assert jretraining.run_if_drifted(jconfig.DriftConfig(
        metrics_csv=stable.metrics_csv)) is None
    assert not (tmp_path / "mlruns").exists()
    _csv(tmp_path / "drifted.csv", 20.0)
    res = retraining.run_if_drifted(
        config.DriftConfig(metrics_csv=str(tmp_path / "drifted.csv")), cfg,
        TINY, arrays=arrays, device="cpu")
    assert res.succeeded and res.version == 1
    assert res.drift_profile_path is not None


def test_pipeline_result_is_the_jax_packages():
    def shape(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert shape(retraining.PipelineResult) == shape(
        jretraining.PipelineResult)


def test_capture_counts_one_graph_per_shape_as_jax_traces(arrays):
    """A capture over frames of two camera sizes: one capture per size on
    the port's guard, as the JAX analyzer traces once per size."""
    net = trainer.init_model(TINY, 0, torch.device("cpu")).eval()
    variables = weights.to_flax_variables(net)
    rng = np.random.default_rng(5)
    frames = [render_scene(rng, h, w)[::2]
              for h, w in ((96, 128), (96, 128), (120, 160), (96, 128))]
    recompile.reset()
    jrecompile.reset()
    try:
        got = profile.capture_feature_profile(net, frames, img_size=32,
                                              device="cpu")
        want = jprofile.capture_feature_profile(
            build_unet(jconfig.ModelConfig(**dataclasses.asdict(TINY))),
            variables, frames, img_size=32)
        assert got.n_frames == want.n_frames == 4

        def counts(snapshot):
            return {name: [e["traces"] for e in entries if e["traces"]]
                    for name, entries in snapshot.items()
                    if any(e["traces"] for e in entries)}

        assert counts(recompile.snapshot()) == counts(
            jrecompile.snapshot()) == {"pipeline.frame_analyzer": [2]}
    finally:
        recompile.reset()
        jrecompile.reset()
